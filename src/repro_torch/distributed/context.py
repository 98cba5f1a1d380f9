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
sits on which grid entry, and ``Blocks`` is a leaf laid out by it
(``launch.sharding.place``): the tensor each entry holds, one tensor for
the entries that share a device and a slice. ``models.sharded`` runs the
plan: each data row's blocks on their entries' devices, joined by the
collectives here (``move``, ``sum_to``, ``reduce_replicas``), each a
``.to`` copy plus adds that autograd differentiates, each counting its
bytes by kind in ``GRID_STATS``. ``constrain`` checks its axes against the
tensor's rank and returns the tensor unchanged: a GSPMD layout hint has no
eager counterpart and never changes values. The reference's
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


# ------------------------------------------------------------ executing a plan


def active_grid():
    """The active grid when it has more than one entry, else None: a 1x1
    grid runs the same code, and gives the same bits, as no grid."""
    ctx = get_ctx()
    return ctx.mesh if ctx is not None and ctx.mesh.devices.size > 1 else None


def grid_index_rows(grid) -> list:
    """[D][M] grid indices (tuples over the grid's axes): the data rows
    (the "pod" and "data" axes, row-major, as the batch splits) by the
    model index."""
    names = grid.axis_names
    if set(names) - {"pod", "data", "model"}:
        raise ValueError(f"grid axes {names}: expected only pod, data and model")
    data = [a for a in ("pod", "data") if a in names]
    M = grid.shape.get("model", 1)
    rows = []
    for d in itertools.product(*(range(grid.shape[a]) for a in data)):
        at = dict(zip(data, d))
        rows.append([tuple(at[a] if a != "model" else m for a in names) for m in range(M)])
    return rows


class Blocks:
    """A leaf laid out on a grid by its plan (a ``NamedSharding``):
    ``tensors[idx]`` is the block grid entry ``idx`` holds, on that entry's
    device. Entries with the same device and the same slice hold one
    tensor, so a replicated leaf is held once per distinct device and a
    split leaf keeps its blocks apart even where a grid repeats a device.
    A tree walk takes it as a leaf; ``distinct`` and ``with_tensors`` are
    its tensors for autograd and the optimizer."""

    __slots__ = ("sharding", "shape", "tensors")

    def __init__(self, sharding: NamedSharding, shape, tensors: dict):
        self.sharding, self.shape, self.tensors = sharding, tuple(shape), tensors

    def __repr__(self) -> str:
        return f"Blocks({self.shape}, {self.sharding.spec}, {len(self.distinct())} tensors)"

    @property
    def grid(self):
        return self.sharding.mesh

    def block(self, idx) -> "torch.Tensor":
        return self.tensors[idx]

    def distinct(self) -> list:
        """Each tensor once, in grid order."""
        seen, out = set(), []
        for t in self.tensors.values():
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
        return out

    def with_tensors(self, tensors: list) -> "Blocks":
        """The same layout holding ``tensors`` (in ``distinct`` order)."""
        new = dict(zip((id(t) for t in self.distinct()), tensors))
        return Blocks(self.sharding, self.shape, {i: new[id(t)] for i, t in self.tensors.items()})

    def replicas(self) -> list:
        """[[tensor, ...] a distinct slice]: the tensors holding each slice
        (one a device), in grid order."""
        groups: dict = {}
        for idx, sl in self.sharding.blocks(self.shape).items():
            key = tuple((s.start, s.stop) for s in sl)
            held = groups.setdefault(key, [])
            t = self.tensors[idx]
            if all(t is not h for _, h in held):
                held.append((idx, t))
        return list(groups.values())

    def __getitem__(self, i: int) -> "Blocks":
        """Index ``i`` of the leading dimension (a stage's repeat axis,
        which no plan splits)."""
        spec = tuple(self.sharding.spec)
        if spec and spec[0] is not None:
            raise ValueError(f"cannot index dimension 0 split as {spec[0]!r}")
        memo: dict = {}
        tensors = {}
        for idx, t in self.tensors.items():
            if id(t) not in memo:
                memo[id(t)] = t[i]
            tensors[idx] = memo[id(t)]
        return Blocks(NamedSharding(self.grid, PartitionSpec(*spec[1:])), self.shape[1:], tensors)

    def assemble(self, device=None):
        """The whole leaf on ``device`` (default: the first block's)."""
        import torch

        first = self.distinct()[0]
        out = torch.empty(self.shape, dtype=first.dtype,
                          device=first.device if device is None else device)
        for idx, sl in self.sharding.blocks(self.shape).items():
            out[sl] = self.tensors[idx].to(out.device)
        return out


# bytes the grid's collectives moved since ``reset_grid_stats``, by kind:
# "model_bcast" (a row's replicated activation to its model blocks, the
# second half of a sum over "model"), "model_sum" (row-parallel partial
# sums to the row's first entry), "model_gather" (columns a block's whole
# heads need from other blocks), "data_sum" (gradients and losses over the
# data axes), "expert_all_to_all" (``moe_apply_ep``'s exchanges),
# "data_gather" (a forward's outputs to the first device); under "bytes"
# all that left its grid entry, under "device_bytes" what crossed between
# distinct devices, under "received" by (receiving entry, kind) (the
# backward's copies included: a copy's gradient moves the same bytes
# back). A gradient's sum over the data axes counts, at each entry whose
# slice other data rows also hold, the slice's bytes once (an all-reduce's
# operand, as the reference's collective count), whether or not the
# entries share a device.
GRID_STATS: dict = {}


def reset_grid_stats() -> None:
    GRID_STATS.clear()
    GRID_STATS.update(bytes={}, device_bytes={}, received={})


reset_grid_stats()


def _add(table: dict, key, n: int) -> None:
    table[key] = table.get(key, 0) + n


def count_bytes(kind: str, nbytes: int, src, dst, grid, t=None) -> None:
    """Count ``nbytes`` from grid entry ``src`` to ``dst`` under ``kind``
    (nothing when they are one entry); with ``t`` a tensor that autograd
    tracks, its gradient's way back is counted when the backward reaches
    it."""
    if src == dst or not nbytes:
        return
    _add(GRID_STATS["bytes"], kind, nbytes)
    _add(GRID_STATS["received"], (dst, kind), nbytes)
    if grid.devices[src] != grid.devices[dst]:
        _add(GRID_STATS["device_bytes"], kind, nbytes)
    if t is not None and t.requires_grad:
        def back(g):
            count_bytes(kind, nbytes, dst, src, grid)
        t.register_hook(back)


def move(t, src, dst, grid, kind: str):
    """``t`` from grid entry ``src`` to entry ``dst``'s device (no copy
    where they share one), counted under ``kind``; differentiable."""
    import torch

    out = t.to(torch.device(grid.devices[dst]))
    count_bytes(kind, t.numel() * t.element_size(), src, dst, grid, out)
    return out


def sum_to(parts: list, dst, grid, kind: str):
    """The sum of ``parts`` ([(grid index, tensor)]) on entry ``dst``,
    added in list order; differentiable."""
    total = None
    for src, t in parts:
        t = move(t, src, dst, grid, kind)
        total = t if total is None else total + t
    return total


_entry = threading.local()


def current_entry():
    """The grid entry whose block the running code computes (set by
    ``at_entry``; None outside one): the dry run's count attributes each
    operation to it."""
    return getattr(_entry, "idx", None)


@contextlib.contextmanager
def at_entry(idx):
    prev = current_entry()
    _entry.idx = idx
    try:
        yield
    finally:
        _entry.idx = prev


def reduce_replicas(tree):
    """Gradients of a placed tree: each slice's replicas summed (in grid
    order, on the first holder's device) and the sum copied back to every
    holder, so each replica ends equal to the others bitwise; the copies
    that cross devices count as "device_bytes" of "data_sum" (within a data
    row, "model_sum"). Each entry whose slice other data rows hold counts
    the slice's bytes as "data_sum" (``GRID_STATS``). Leaves that are not
    ``Blocks`` pass through."""
    from repro_torch.common.pytree import tree_map_with_path

    def one(_path, leaf):
        if not isinstance(leaf, Blocks):
            return leaf
        grid = leaf.grid
        row_of = {idx: r for r, row in enumerate(grid_index_rows(grid)) for idx in row}
        rows_with: dict = {}
        for idx, sl in leaf.sharding.blocks(leaf.shape).items():
            rows_with.setdefault(tuple((s.start, s.stop) for s in sl), set()).add(row_of[idx])
        for idx, sl in leaf.sharding.blocks(leaf.shape).items():
            if len(rows_with[tuple((s.start, s.stop) for s in sl)]) > 1:
                t = leaf.tensors[idx]
                nbytes = t.numel() * t.element_size()
                _add(GRID_STATS["bytes"], "data_sum", nbytes)
                _add(GRID_STATS["received"], (idx, "data_sum"), nbytes)
        new = {}
        for held in leaf.replicas():
            if len(held) == 1:
                new[id(held[0][1])] = held[0][1]
                continue
            i0, total = held[0]
            for i, t in held[1:]:
                total = total + _device_copy(t, i, i0, grid, row_of)
            for i, t in held:  # each holder its own tensor, as it came
                new[id(t)] = total if i == i0 else _device_copy(total, i0, i, grid, row_of)
        return leaf.with_tensors([new[id(t)] for t in leaf.distinct()])

    return tree_map_with_path(one, tree)


def _device_copy(t, src, dst, grid, row_of):
    import torch

    dev = torch.device(grid.devices[dst])
    if t.device != dev:
        kind = "model_sum" if row_of[src] == row_of[dst] else "data_sum"
        _add(GRID_STATS["device_bytes"], kind, t.numel() * t.element_size())
    return t.to(dev, copy=True)
