"""Compressed representation of vector-quantized activations (paper
§3.1-3.2) — the port of ``repro/core/compressed.py``.

A (batched) activation tensor ``X ∈ R^{b×n×d}`` whose rows are drawn from a
small set of unique vectors is stored as a codebook ``C ∈ R^{q×d}`` plus an
index map ``P ∈ {0..q-1}^{b×n}`` with ``X[b,n,:] = C[P[b,n],:]``.

Two facts make this useful (paper §3.2):

* *per-location* ops ``Y = F(X)`` with ``Y[i,j,:] = f(X[i,j,:])`` reduce to
  ``(P, f(C))`` — cost ``O(q·cost(f))`` instead of ``O(b·n·cost(f))``;
* *binary element-wise* ops between two compressed tensors reduce to applying
  ``f`` on the **unique pairs** of codebook rows (App. A.3).

``Compressed`` is a plain dataclass of tensors. The eager paths
(``capacity=None``) keep the reference's exact sizes and sort orders:
``compress`` dedups rows with ``np.unique(axis=0)`` on the host, ``binary``
and ``recompress`` number the sorted unique keys. With a ``capacity`` the
unique keys are padded to it with −1, as ``jnp.unique(size=,
fill_value=-1)`` pads them, and padded rows take codebook row 0.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch


@dataclass
class Compressed:
    """codebook: [cap, d]; idx: int32 [...] with values in [0, n_codes)."""

    codebook: torch.Tensor
    idx: torch.Tensor
    n_codes: torch.Tensor  # scalar int32 <= cap

    @property
    def capacity(self) -> int:
        return self.codebook.shape[0]

    @property
    def d(self) -> int:
        return self.codebook.shape[-1]

    def to_dense(self) -> torch.Tensor:
        return self.codebook[self.idx.long()]

    def occupancy(self) -> torch.Tensor:
        """Number of *distinct* codes actually referenced by idx."""
        used = torch.zeros((self.capacity,), dtype=torch.bool, device=self.idx.device)
        used[self.idx.reshape(-1).long()] = True
        return used.sum()


def _int32(n, device) -> torch.Tensor:
    return torch.as_tensor(n, dtype=torch.int32, device=device)


def from_dense_rows(rows: torch.Tensor, idx: torch.Tensor, n_codes=None) -> Compressed:
    """Wrap explicit (codebook, idx) without dedup."""
    if n_codes is None:
        n_codes = rows.shape[0]
    return Compressed(rows, idx.to(torch.int32), _int32(n_codes, rows.device))


def from_tokens(embedding: torch.Tensor, tokens: torch.Tensor) -> Compressed:
    """Token embeddings are 'born quantized' (paper footnote 1): the embedding
    matrix is the codebook and the token ids are the index map."""
    return Compressed(embedding, tokens.to(torch.int32),
                      _int32(embedding.shape[0], embedding.device))


def compress(x: torch.Tensor, capacity: Optional[int] = None) -> Compressed:
    """Dedup the rows of a dense tensor [..., d] into a Compressed (eager,
    exact size; rows in ``np.unique``'s lexicographic order)."""
    *lead, d = x.shape
    if capacity is not None:
        raise NotImplementedError(
            "fixed-capacity dense compression is not needed: activations are "
            "constructed in compressed form by the VQ layers.")
    flat = x.reshape(-1, d).detach().cpu().numpy()
    uniq, inverse = np.unique(flat, axis=0, return_inverse=True)
    return Compressed(torch.as_tensor(uniq, device=x.device),
                      torch.as_tensor(inverse.reshape(lead), dtype=torch.int32, device=x.device),
                      _int32(uniq.shape[0], x.device))


def per_location(f: Callable[[torch.Tensor], torch.Tensor], c: Compressed) -> Compressed:
    """Apply a per-location vector op on the codebook only (paper eq. 2)."""
    return Compressed(f(c.codebook), c.idx, c.n_codes)


def _unique(flat: torch.Tensor, capacity: Optional[int]):
    """Sorted unique values of ``flat`` and each entry's index among them;
    with ``capacity``, the values padded to it with −1 (or cut to it, as
    ``jnp.unique(size=)`` does). Returns (uniq, inverse, n_codes)."""
    uniq, inverse = torch.unique(flat, sorted=True, return_inverse=True)
    if capacity is None:
        return uniq, inverse, uniq.shape[0]
    n_codes = min(uniq.shape[0], capacity)
    padded = torch.full((capacity,), -1, dtype=flat.dtype, device=flat.device)
    padded[:n_codes] = uniq[:capacity]
    return padded, inverse, n_codes


def binary(f: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], a: Compressed,
           b: Compressed, capacity: Optional[int] = None) -> Compressed:
    """Binary element-wise op between two compressed tensors (App. A.3):
    dedup the *pairs* of indices and apply ``f`` once per unique pair."""
    if a.idx.shape != b.idx.shape:
        raise ValueError(f"index maps differ in shape: {tuple(a.idx.shape)} vs "
                         f"{tuple(b.idx.shape)}")
    key = a.idx.to(torch.int64) * int(b.capacity) + b.idx.to(torch.int64)
    uniq, inverse, n_codes = _unique(key.reshape(-1), capacity)
    ia = torch.div(uniq.clamp(min=0), int(b.capacity), rounding_mode="floor")
    ib = uniq.clamp(min=0) % int(b.capacity)
    rows = f(a.codebook[ia], b.codebook[ib])
    return Compressed(rows, inverse.reshape(a.idx.shape).to(torch.int32),
                      _int32(n_codes, rows.device))


def add(a: Compressed, b: Compressed, capacity: Optional[int] = None) -> Compressed:
    """Residual connection over compressed tensors."""
    return binary(torch.add, a, b, capacity=capacity)


def recompress(c: Compressed, capacity: Optional[int] = None) -> Compressed:
    """Drop unreferenced codebook rows (keeps codebooks from growing across
    layers; the paper's additive-growth argument keeps this O(n+b))."""
    uniq, inverse, n_codes = _unique(c.idx.reshape(-1).to(torch.int32), capacity)
    rows = c.codebook[uniq.clamp(min=0).long()]
    return Compressed(rows, inverse.reshape(c.idx.shape).to(torch.int32),
                      _int32(n_codes, rows.device))


def base_and_deltas(c: Compressed) -> tuple[torch.Tensor, torch.Tensor]:
    """Sparse representation of a batch index map (paper §3.1, fig. 2).

    For idx of shape [b, n], returns (base [n], delta_mask [b, n]) where
    ``base[j]`` is the most frequent index at sequence location j (the lowest
    among tied modes) and ``delta_mask[i, j] = idx[i, j] != base[j]``. The
    number of True entries in delta_mask is the O(b) side of the paper's
    O(n+b) storage bound.
    """
    idx = c.idx
    if idx.ndim != 2:
        raise ValueError("base_and_deltas expects a [batch, seq] index map")
    counts = torch.nn.functional.one_hot(idx.long(), c.capacity).sum(0)  # [n, cap]
    base = torch.argmax(counts, dim=-1).to(torch.int32)  # first maximum
    return base, idx != base[None, :]
