"""Ambient sharding context — ``repro/distributed/context.py`` on the port.

Model code may name *logical* axes ("batch", "seq", "model", "seq_model");
while a ``ShardingCtx`` is active they resolve against the grid's axes,
and with no context (unit tests, eager runs on one device) nothing is
resolved. This keeps the model definitions grid-agnostic.

Logical axes:
  batch     -> all data-parallel grid axes ("pod", "data") when present
  seq       -> "data" (context/sequence parallelism, long-context decode)
  model     -> "model" (tensor parallelism: heads, ffn hidden, vocab, experts)
  seq_model -> "model" (context parallelism on the tensor axis, for head
               counts that do not divide it)

The port has one process and a grid of ``torch.device`` entries
(``launch.mesh.Grid``), and no tensor spans devices. So a spec is a plan:
``NamedSharding(grid, spec).blocks(shape)`` says which block of a leaf
sits on which grid entry. ``models.moe.moe_apply_ep`` runs such a plan for
the expert stacks. ``constrain`` checks its axes against the tensor's rank
and returns the tensor unchanged: a GSPMD layout hint has no eager
counterpart and never changes values. The reference's
``shard_map_compat`` is a shim across jax versions and has no counterpart:
the port loops over the grid where the reference maps a function over it.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
from dataclasses import dataclass
from typing import Optional

_state = threading.local()


class PartitionSpec(tuple):
    """One entry a dimension: None (replicated), a grid axis name, or a
    tuple of names (the dimension split over their product, the first the
    slowest). A one-name tuple is that name, as jax normalizes it. Equal
    to the reference's ``tuple(spec)``."""

    def __new__(cls, *entries):
        norm = (tuple(e) if isinstance(e, (tuple, list)) else e for e in entries)
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in norm))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _axes(entry) -> tuple:
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


class NamedSharding:
    """A spec over a grid (``launch.mesh.Grid``): the plan for one leaf.
    Not a dataclass, so the port's tree walks take it as a leaf."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, PartitionSpec(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    def blocks(self, shape) -> dict:
        """{grid index: tuple of slices}: the block of a ``shape`` leaf that
        each grid entry holds. Raises where a split does not divide its
        dimension (the sharding rules drop such entries to None first)."""
        grid = self.mesh
        names = list(grid.axis_names)
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        if len(spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than shape {tuple(shape)}")
        out = {}
        for idx in itertools.product(*(range(grid.shape[a]) for a in names)):
            sl = []
            for dim, entry in zip(shape, spec):
                parts, k = 1, 0
                for a in _axes(entry):
                    parts *= grid.shape[a]
                    k = k * grid.shape[a] + idx[names.index(a)]
                if dim % parts:
                    raise ValueError(f"dimension {dim} does not split {parts} ways ({entry})")
                step = dim // parts
                sl.append(slice(k * step, (k + 1) * step))
            out[idx] = tuple(sl)
        return out


@dataclass
class ShardingCtx:
    mesh: object  # launch.mesh.Grid

    def resolve(self, logical: Optional[str]):
        if logical is None:
            return None
        names = self.mesh.axis_names
        if logical == "batch":
            axes = tuple(a for a in ("pod", "data") if a in names)
            return axes if axes else None
        if logical == "seq":
            return "data" if "data" in names else None
        if logical == "model":
            return "model" if "model" in names else None
        if logical == "seq_model":
            # context parallelism ON the tensor axis: used when head counts
            # don't divide the model axis (hymba 25H, phi4 24H, internvl 14H)
            return "model" if "model" in names else None
        raise ValueError(f"unknown logical axis {logical}")

    def spec(self, *logical_axes, dims: Optional[tuple] = None) -> PartitionSpec:
        """Resolve logical axes with two safeguards: a grid axis may appear
        only once per spec (first use wins — batch=1 decode wants both
        "batch" and "seq" on "data"); and when ``dims`` is given, axes whose
        dimension does not divide the grid-axis size resolve to None (so a
        batch-1 tensor never claims the data axis and the seq axis can)."""
        used: set = set()
        out = []
        for i, a in enumerate(logical_axes):
            r = self.resolve(a)
            flat = r if isinstance(r, tuple) else (r,)
            if r is not None and dims is not None:
                size = 1
                for f in flat:
                    size *= self.mesh.shape[f]
                if dims[i] % size != 0:
                    r = None
            if r is None or any(f in used for f in flat):
                out.append(None)
            else:
                used.update(flat)
                out.append(r)
        return PartitionSpec(*out)


def set_ctx(ctx: Optional[ShardingCtx]) -> None:
    _state.ctx = ctx


def get_ctx() -> Optional[ShardingCtx]:
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def use_mesh(mesh):
    prev = get_ctx()
    set_ctx(ShardingCtx(mesh))
    try:
        yield get_ctx()
    finally:
        set_ctx(prev)


def with_ctx(ctx: Optional[ShardingCtx], fn):
    """``fn`` run under ``ctx`` whatever context, and whatever thread,
    calls it. A layer body that ``torch.utils.checkpoint`` recomputes in
    the backward (on the card in autograd's device thread, where this
    thread-local context is unset) then sees the grid its forward saw, as
    a jax trace binds its mesh once."""

    def run(*args, **kw):
        prev = get_ctx()
        set_ctx(ctx)
        try:
            return fn(*args, **kw)
        finally:
            set_ctx(prev)

    return run


def constrain(x, *logical_axes):
    """The reference's sharding constraint by logical axis names: ``x``
    unchanged (no-op without a context; with one, the axes must match
    ``x``'s rank, as the reference checks)."""
    if get_ctx() is None:
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(f"constrain: {len(logical_axes)} axes for rank-{x.ndim}")
    return x
