"""Parameter / batch / cache sharding rules for the production grid —
``repro/launch/sharding.py`` on the port.

Rules are name-based (matching the parameter dict keys used by the model
modules) and rank-aware: stage parameters carry a leading ``repeat`` axis
from the stage stacking, so the *core* spec for the trailing dims is padded
with ``None`` on the left. The port's trees are the reference's, path for
path and shape for shape: parameters, ``TrainState`` and the decode caches
(whose stages carry the same leading repeat axis, ``[r, b, S, ...]``). So
each rule applies as written and every spec equals the reference's
(``tests/test_torch_sharding.py``).

Baseline policy:
  * tensor parallelism on ``model``: attention heads / FFN hidden / vocab /
    MoE experts;
  * data parallelism on ``("pod", "data")`` for batch-bearing tensors;
  * sequence parallelism on ``data`` for batch-1 long-context decode caches;
  * everything small (norms, biases, codebooks, routers) replicated.

Each function returns the tree with every leaf replaced by a
``NamedSharding(grid, spec)``: a plan, whose ``blocks(shape)`` says which
block of the leaf each grid entry holds. ``place`` carries a plan out: each
leaf becomes a ``distributed.context.Blocks`` of copies on the entries'
devices (``place_state`` for a ``TrainState``, ``place_batch`` for a
batch, ``place_caches`` for decode caches; ``unplace`` assembles the whole
leaves again). ``models.sharded`` runs the forward, the train step and the
decode step over such blocks, and lays a tree of whole leaves out on the
fly (``lay_out``, differentiable) when it is given one.
"""
from __future__ import annotations

import numpy as np

from repro_torch.common.pytree import (
    path_entry_name, tree_flatten_with_path, tree_map_with_path,
)
from repro_torch.distributed.context import Blocks, NamedSharding, PartitionSpec as P
from repro_torch.launch.mesh import Grid


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


# name -> core spec over the trailing dims (padded left with None to rank)
_CORE_RULES: dict[str, tuple] = {
    # attention / hymba
    "wq": (None, "model"),
    "wk": (None, "model"),
    "wv": (None, "model"),
    "wo": ("model", None),
    "bq": ("model",),
    "bk": ("model",),
    "bv": ("model",),
    "bo": (None,),
    "w_xz": (None, "model"),
    "conv_w": (None, "model"),
    "conv_b": ("model",),
    # mla
    "w_dq": (None, None),
    "w_uq": (None, "model"),
    "w_dkv": (None, None),
    "w_uk": (None, "model"),
    "w_uv": (None, "model"),
    # rwkv time-mix (square d x d) / channel-mix handled by parent context
    "w_r": (None, "model"),
    "w_g": (None, "model"),
    "w_o": ("model", None),
    "w_dec_a": (None, None),
    "w_dec_b": (None, None),
    # dense ffn
    "w_gate": (None, "model"),
    "w_up": (None, "model"),
    "w_down": ("model", None),
    "b_up": ("model",),
    "b_down": (None,),
    # heads / embeddings
    "lm_head": (None, "model"),
    "proj": (None, None),
    "vis_proj": (None, None),
    "router": (None, None),
}

_REPLICATED = {
    "scale", "bias", "mu", "u", "w0", "gn_scale", "gn_bias", "codebook",
    "w_B", "w_C", "w_dt", "dt_bias", "A_log", "pos", "norm_attn", "norm_ssm",
    "step", "rng",
}


def _spec_for(path: tuple[str, ...], shape: tuple[int, ...]) -> P:
    name = path[-1]
    rank = len(shape)
    if name == "tok":
        # [vocab, d] or audio [cb, vocab, d]: shard the vocab axis
        core = ("model", None) if rank == 2 else (None, "model", None)
        return P(*core)
    if name in _REPLICATED:
        return P(*([None] * rank))
    # MoE expert tensors: rank-4 [repeat, E, d, f] — shard experts
    if name in ("w_gate", "w_up", "w_down") and rank == 4:
        return P(None, "model", None, None)
    if name in ("w_gate", "w_up", "w_down") and rank == 3 and "shared" not in path:
        core = _CORE_RULES[name]
        return P(*([None] * (rank - len(core)) + list(core)))
    # rwkv channel-mix w_v: [d, d_ff] (mixer w_v is [d, d] — same rule works)
    if name in _CORE_RULES:
        core = _CORE_RULES[name]
        if rank < len(core):
            return P(*([None] * rank))
        return P(*([None] * (rank - len(core)) + list(core)))
    if name == "w_k":  # rwkv tm [d,d] / cm [d,d_ff]
        return P(*([None] * (len(shape) - 2) + [None, "model"]))
    if name == "w_v":  # rwkv tm [d,d] -> col shard; cm [d_ff,d] -> row shard
        # disambiguate by parent: cm lives under "ffn"
        if "ffn" in path:
            return P(*([None] * (len(shape) - 2) + ["model", None]))
        return P(*([None] * (len(shape) - 2) + [None, "model"]))
    return P(*([None] * rank))


def _divisible(spec: P, shape: tuple, mesh: Grid) -> P:
    """Drop spec entries whose mesh-axis product does not divide the dim —
    a block plan (like jit in_shardings) needs exact divisibility
    (e.g. hymba's vocab 32001, phi's 24 heads on a 16-way model axis)."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        out.append(entry if dim % size == 0 else None)
    return P(*out)


def param_shardings(tree, mesh: Grid):
    """NamedSharding pytree matching ``tree`` (params / TrainState / opt)."""

    def one(path, leaf):
        names = tuple(path_entry_name(p) for p in path)
        shape = _shape(leaf)
        if len(shape) == 0:
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, _divisible(_spec_for(names, shape), shape, mesh))

    return tree_map_with_path(one, tree)


def batch_shardings(batch, mesh: Grid, *, seq_sharded: bool = False):
    """Training / prefill batches: leading axis on all data axes. With
    ``seq_sharded`` (batch-1 long-context), the sequence axis goes on "data"."""
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)

    n_data = 1
    for a in data_axes:
        n_data *= mesh.shape[a]

    def one(path, leaf):
        shape = _shape(leaf)
        if len(shape) == 0:
            return NamedSharding(mesh, P())
        if seq_sharded and len(shape) >= 2 and shape[1] % mesh.shape["data"] == 0:
            return NamedSharding(mesh, P(None, "data", *([None] * (len(shape) - 2))))
        if shape[0] % max(n_data, 1) != 0:  # e.g. batch-1 long-context decode
            return NamedSharding(mesh, P(*([None] * len(shape))))
        return NamedSharding(
            mesh, P(data_axes if data_axes else None, *([None] * (len(shape) - 1)))
        )

    return tree_map_with_path(one, batch)


def serving_batch_sharding(mesh: Grid, axis: str = "data") -> NamedSharding:
    """Leading-(document-)axis sharding for the batched serving stack
    (DESIGN.md §6): one value covers every leaf of a batched state, edit
    bucket or KV export — dim 0 (the batch of documents) splits across
    ``axis``, all trailing dims replicate. The port's serving mesh
    (``make_serving_mesh``, a device list) runs this plan: each entry
    takes one contiguous block of the dispatch's rows."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no axis {axis!r}")
    return NamedSharding(mesh, P(axis))


def decode_splits_batch(mesh: Grid, batch: int) -> bool:
    """Whether ``cache_shardings`` splits a decode batch over the data axes
    (batch >= their size and divisible by it); else the caches' sequence
    axis goes on "data"."""
    n_data = 1
    for a in ("pod", "data"):
        n_data *= mesh.shape.get(a, 1)
    return batch % n_data == 0 and batch >= n_data


def cache_shardings(caches, mesh: Grid, *, batch: int):
    """Decode caches. Layout (after the stage-stacking leading axis):
    k/v [r, b, S, Hkv, dh]; mla ckv [r, b, S, c]; ssm [r, b, H, dk, dv];
    'len' [r, b]. Batch >= data size -> shard batch; else shard the sequence
    axis on "data" (long-context batch-1 decode)."""
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    shard_batch = decode_splits_batch(mesh, batch)

    def one(path, leaf):
        names = tuple(path_entry_name(p) for p in path)
        shape = _shape(leaf)
        rank = len(shape)
        name = names[-1]
        if rank <= 1:
            return NamedSharding(mesh, P())
        if name == "len":
            return NamedSharding(
                mesh, _divisible(P(None, data_axes if shard_batch else None), shape, mesh)
            )
        b_spec = data_axes if shard_batch else None
        s_spec = None if shard_batch else ("data" if "data" in mesh.axis_names else None)
        if name in ("k", "v"):  # [r, b, S, Hkv, dh]
            spec = P(None, b_spec, s_spec, "model", None)
        elif name in ("ckv", "krope"):  # [r, b, S, c]
            spec = P(None, b_spec, s_spec, None)
        elif name == "ssm_state":  # [r, b, H, dk, dv]
            spec = P(None, b_spec, "model", None, None)
        elif name == "conv_state":  # [r, b, K-1, d_inner]
            spec = P(None, b_spec, None, "model")
        elif name == "S":  # rwkv [r, b, H, dh, dh]
            spec = P(None, b_spec, "model", None, None)
        elif name in ("x_last", "cm_x_last"):  # [r, b, d]
            spec = P(None, b_spec, None)
        else:
            spec = P(*([None] * rank))
        return NamedSharding(mesh, _divisible(spec, shape, mesh))

    return tree_map_with_path(one, caches)


def lay_out(leaf, sharding: NamedSharding, *, copy: bool = True,
            share=True) -> Blocks:
    """``leaf`` (a whole tensor) as the ``Blocks`` its plan names: one
    tensor a distinct (device, slice); with ``share=False`` one an entry
    (each its own copy, as on a grid of distinct cards), with
    ``share="row"`` one a distinct (device, slice) within each data row
    (the dry run: no gradient adds across rows). With ``copy`` each is a
    detached contiguous copy (``place``); without, a differentiable slice
    moved to the entry's device, the leaf itself where the slice is whole
    and the device its own (the forward's layout of whole leaves)."""
    import torch

    from repro_torch.distributed.context import grid_index_rows

    row_of = ({i: r for r, row in enumerate(grid_index_rows(sharding.mesh)) for i in row}
              if share == "row" else {})
    held: dict = {}
    tensors = {}
    shape = tuple(leaf.shape)
    for idx, sl in sharding.blocks(shape).items():
        dev = torch.device(sharding.mesh.devices[idx])
        key = (dev, tuple((s.start, s.stop) for s in sl),
               row_of[idx] if share == "row" else None if share else idx)
        t = held.get(key)
        if t is None:
            whole = all(s.start == 0 and s.stop == d for s, d in zip(sl, shape))
            if copy:
                t = leaf.detach()[sl].to(dev, copy=True).contiguous()
            else:
                t = (leaf if whole else leaf[sl]).to(dev)
            held[key] = t
        tensors[idx] = t
    return Blocks(sharding, shape, tensors)


def place(tree, mesh: Grid, *, copy: bool = True, share=True):
    """``tree`` (parameters, or AdamW moments of the same paths) laid out by
    ``param_shardings`` (``lay_out``): every leaf of rank >= 1 a
    ``Blocks``; a leaf that already is one stays."""
    plans = iter(s for _, s in tree_flatten_with_path(param_shardings(tree, mesh)))

    def one(_path, leaf):
        plan = next(plans)
        if isinstance(leaf, Blocks) or leaf.dim() == 0:
            return leaf
        return lay_out(leaf, plan, copy=copy, share=share)

    return tree_map_with_path(one, tree)


def place_state(state, mesh: Grid, *, share=True):
    """A ``training.step.TrainState`` by its plan: the parameters and both
    AdamW moments laid out alike (``param_shardings`` of the state gives
    them the same specs), the step on the grid's first device, the host
    rng pair as it is."""
    import dataclasses

    import torch

    first = torch.device(mesh.devices.flat[0])
    lay = lambda t: place(t, mesh, share=share)  # noqa: E731
    opt = dataclasses.replace(state.opt, step=state.opt.step.to(first),
                              mu=lay(state.opt.mu), nu=lay(state.opt.nu))
    return dataclasses.replace(state, params=lay(state.params), opt=opt)


def place_batch(batch: dict, mesh: Grid) -> dict:
    """A training / prefill batch laid out by ``batch_shardings``: rows over
    the data axes, each row block once a distinct device of its row."""
    import torch

    plans = batch_shardings(batch, mesh)
    return {k: lay_out(torch.as_tensor(v), plans[k]) for k, v in batch.items()}


def place_caches(caches, mesh: Grid, *, batch: int, share=True):
    """Decode caches (``transformer.init_caches``' tree) laid out by
    ``cache_shardings`` (``lay_out``: each block a copy on its entry's
    device; ``share`` as there). A split that does not divide its
    dimension is dropped (``_divisible``): that leaf is replicated, and the
    decode step updates it once and copies the update to every holder."""
    plans = iter(s for _, s in tree_flatten_with_path(
        cache_shardings(caches, mesh, batch=batch)))

    def one(_path, leaf):
        plan = next(plans)
        return leaf if isinstance(leaf, Blocks) else lay_out(leaf, plan, share=share)

    return tree_map_with_path(one, caches)


def unplace(tree, device=None):
    """``tree`` with every ``Blocks`` assembled into its whole leaf."""
    return tree_map_with_path(
        lambda _p, leaf: leaf.assemble(device) if isinstance(leaf, Blocks) else leaf, tree)
