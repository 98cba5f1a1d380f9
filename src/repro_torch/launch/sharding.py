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
block of the leaf each grid entry holds. ``models.moe.place_experts``
carries out the plan of the expert stacks; running the dense leaves split
over ``model`` and batches over ``data`` is ROADMAP's next item.
"""
from __future__ import annotations

import numpy as np

from repro_torch.common.pytree import path_entry_name, tree_map_with_path
from repro_torch.distributed.context import NamedSharding, PartitionSpec as P
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


def cache_shardings(caches, mesh: Grid, *, batch: int):
    """Decode caches. Layout (after the stage-stacking leading axis):
    k/v [r, b, S, Hkv, dh]; mla ckv [r, b, S, c]; ssm [r, b, H, dk, dv];
    'len' [r, b]. Batch >= data size -> shard batch; else shard the sequence
    axis on "data" (long-context batch-1 decode)."""
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    n_data = 1
    for a in data_axes:
        n_data *= mesh.shape[a]
    shard_batch = batch % max(n_data, 1) == 0 and batch >= n_data

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
