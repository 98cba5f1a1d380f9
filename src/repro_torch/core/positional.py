"""Sampled absolute positional embeddings (paper §3.3, App. B) — the port
of ``repro/core/positional.py``.

Training samples a random *ordered* subset of a large positional-embedding
pool per document (``sample_positions``), so the network learns to use
only the relative order of position ids. At serving time gapped ids
(``spread_positions_gapped``, ``PositionAllocator``) let a token insertion
take a fresh id between its neighbours without shifting anyone else — the
key to reusing activations across insert/delete edits.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.vq import gumbel as gumbel_noise


def _sample(generator, lead: tuple, n: int, pool_size: int,
            gumbel: Optional[torch.Tensor]) -> torch.Tensor:
    if n > pool_size:
        raise ValueError(f"n={n} > pool_size={pool_size}")
    if gumbel is None:
        gumbel = gumbel_noise(generator, lead + (pool_size,))
    elif tuple(gumbel.shape) != lead + (pool_size,):
        raise ValueError(f"gumbel noise must be {lead + (pool_size,)}, got {tuple(gumbel.shape)}")
    # Gumbel top-k samples n ids without replacement; then sort them
    idx = torch.topk(gumbel, n, dim=-1).indices
    return torch.sort(idx, dim=-1).values.to(torch.int32)


def sample_positions(generator: Optional[torch.Generator], n: int, pool_size: int, *,
                     gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A sorted n-subset of [0, pool_size) as int32 [n] (training mode).
    The Gumbel noise over the pool is drawn from ``generator`` on its
    device, or taken from ``gumbel`` [pool_size] (a test passes the
    reference's ``jax.random.gumbel`` noise, which torch's RNG cannot
    give)."""
    return _sample(generator, (), n, pool_size, gumbel)


def sample_positions_batch(generator: Optional[torch.Generator], batch: int, n: int,
                           pool_size: int, *,
                           gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sample_positions`` for ``batch`` documents: int32 [batch, n], from
    noise [batch, pool_size] (drawn, or ``gumbel``)."""
    return _sample(generator, (batch,), n, pool_size, gumbel)


def spread_positions(n: int, pool_size: int) -> np.ndarray:
    """Deterministic serving-time initial assignment: spread ids evenly so
    every adjacent pair has a gap ~ pool_size/n for future insertions."""
    return (np.arange(n, dtype=np.int64) * pool_size // max(n, 1)).astype(np.int64)


def spread_positions_gapped(n: int, pool_size: int) -> np.ndarray:
    """Even spread leaving a gap at BOTH boundaries — id_i = (i+1)·pool/(n+1)
    — so inserting before the first or after the last token still finds a
    fresh id. This is the allocator's layout (initial and post-defrag)."""
    if n >= pool_size:
        raise ValueError(f"pool of {pool_size} cannot spread {n} gapped ids")
    return ((np.arange(1, n + 1, dtype=np.int64) * pool_size)
            // (n + 1)).astype(np.int64)


class PositionAllocator:
    """Host-side position-id allocator for the online editing engine.

    Maintains the sorted list of in-use position ids aligned with the token
    sequence. ``insert_at`` returns a fresh id strictly between neighbours,
    or None if the gap is exhausted (caller must defragment — paper: "akin
    to defragmentation").
    """

    def __init__(self, n: int, pool_size: int):
        self.pool_size = int(pool_size)
        self.positions: list[int] = self._spread(n)
        self.defrag_count = 0

    def _spread(self, n: int) -> list[int]:
        """Boundary-gapped spread; dense 0..n-1 when the pool is full."""
        if n < self.pool_size:
            return [int(p) for p in spread_positions_gapped(n, self.pool_size)]
        return [int(p) for p in spread_positions(n, self.pool_size)]

    def __len__(self) -> int:
        return len(self.positions)

    def snapshot(self) -> np.ndarray:
        """The in-use ids, sequence-ordered, as an int32 array."""
        return np.asarray(self.positions, np.int32)

    def restore(self, ids) -> None:
        """Adopt a previously snapshotted id sequence (rollback path)."""
        ids = [int(p) for p in np.asarray(ids).reshape(-1)]
        if any(b <= a for a, b in zip(ids, ids[1:])):
            raise ValueError("position ids must be strictly increasing")
        if ids and not (0 <= ids[0] and ids[-1] < self.pool_size):
            raise ValueError(
                f"ids out of pool range [0, {self.pool_size})")
        self.positions = ids

    def gap_at(self, i: int) -> int:
        """Number of free ids strictly between the would-be neighbours of an
        insertion at sequence index i. 0 means ``insert_at(i)`` would fail."""
        lo = self.positions[i - 1] if i > 0 else -1
        hi = self.positions[i] if i < len(self.positions) else self.pool_size
        return max(hi - lo - 1, 0)

    def can_insert_at(self, i: int) -> bool:
        return self.gap_at(i) > 0

    def min_gap(self) -> int:
        """The tightest insertion gap anywhere (including both boundaries)."""
        return min(self.gap_at(i) for i in range(len(self.positions) + 1))

    def insert_at(self, i: int) -> int | None:
        """Allocate an id for a token inserted at sequence index i (before the
        current i-th token). Returns the id, or None if no gap remains."""
        lo = self.positions[i - 1] if i > 0 else -1
        hi = self.positions[i] if i < len(self.positions) else self.pool_size
        if hi - lo <= 1:
            return None
        mid = (lo + hi) // 2
        self.positions.insert(i, mid)
        return mid

    def delete_at(self, i: int) -> int:
        return self.positions.pop(i)

    def defragment(self) -> list[int]:
        """Re-spread all ids evenly (gaps at both boundaries). Invalidates
        cached activations (every position embedding changes)."""
        self.positions = self._spread(len(self.positions))
        self.defrag_count += 1
        return self.positions
