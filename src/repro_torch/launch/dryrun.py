"""The dry run on ``meta`` devices — ``repro/launch/dryrun.py`` on the port.

The reference proves a plan by compiling its whole jitted step on
placeholder devices and reads per-device FLOPs, bytes, collectives and
memory from the compiled program. PyTorch lowers no sharded program, so
the port runs its own sharded step (``models.sharded``) on a grid whose
256 (or 512) entries are all the ``meta`` device: every block's shapes
must agree and every product, copy and collective runs, but nothing is
allocated and no kernel launches. What it counts, per grid entry:

* ``flops``: ``torch.utils.flop_counter``'s formulas for each aten op
  (products; element-wise work counts 0 there, as in XLA's count of dots),
  plus the hand-written kernels' operations (``kernels._launch.meta_work``:
  the PERF.md section 6 bound formulas);
* ``bytes``: each op's operands and results (views move nothing), and the
  kernels' compulsory bytes — a count of its own, not XLA's;
* ``collective_bytes`` / ``collectives``: bytes the entry received from
  other entries, by kind (``distributed.context.GRID_STATS``), the
  gradients' all-reduce over the data axes counted as its operand;
* ``memory.argument_bytes``: what the plan places on the entry (state,
  batch, decode caches and tokens: their blocks); ``output_bytes`` the
  outputs' blocks; ``temp_bytes`` null (live meta bytes are not tracked).

An op is attributed to the entry whose block the code computes
(``context.at_entry``), in the backward to the entry its autograd node was
made under, else to the entries that hold its inputs (the optimizer's
update counts at every holder of a replicated block), else to entry 0.
The record reports the entry with the most FLOPs (the reference reports
its partitioned module) and each quantity's maximum over entries.

``model_flops`` is the reference's (``dryrun.py:365-392``). The roofline
terms price the reported entry at the port's H100 numbers
(``launch.roofline``: FP32 outside the tensor cores, HBM) and NVLink.
Every arch runs every shape it supports (``shape_supported``): train,
prefill, and decode (one ``decode_step`` against caches of the shape's
length laid out by ``launch.sharding.place_caches``, each taken as full).

Usage:
  python -m repro_torch.launch.dryrun --arch deepseek-v2-236b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out dryrun.jsonl
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from collections import defaultdict

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.common.pytree import path_names, tree_flatten_with_path
from repro_torch.configs import all_arch_names, get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.context import (
    GRID_STATS, Blocks, current_entry, grid_index_rows, reset_grid_stats, use_mesh,
)
from repro_torch.kernels import _launch
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.sharding import (
    batch_shardings, cache_shardings, lay_out, param_shardings, place, place_batch,
    place_caches, place_state,
)
from repro_torch.launch.specs import (
    SHAPES, ShapeCfg, decode_token_specs, input_specs, shape_supported,
)
from repro_torch.models import sharded
from repro_torch.models import transformer as T

# H100 SXM NVLink 4: 900 GB/s a GPU in both directions, 450 GB/s each way
# (NVIDIA H100 data sheet)
NVLINK_BW = 450e9
_FREE = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
         torch.ops.aten.empty_strided.default, torch.ops.aten.detach.default,
         torch.ops.aten.lift_fresh.default}


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class _Tag(TorchFunctionMode):
    """Tags the autograd nodes each call makes (its result's node and the
    untagged nodes behind it: a 3-d matmul is a view over an mm) with the
    entry of ``at_entry`` (None outside one), so the backward's ops find
    it."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        entry = current_entry()
        stack = [t.grad_fn for t in _tensors(out)]
        while stack:
            node = stack.pop()
            if node is None or "entry" in node.metadata:
                continue
            node.metadata["entry"] = entry
            stack.extend(f for f, _ in node.next_functions)
        return out


class GridCount(TorchDispatchMode):
    """Per-entry FLOPs and bytes of every aten op and kernel call."""

    def __init__(self, default_entry, owners: WeakIdKeyDictionary):
        super().__init__()
        self.default = default_entry
        self.owners = owners  # tensor -> entries holding it
        self.flops = defaultdict(float)
        self.bytes = defaultdict(float)
        self.kernel_flops = defaultdict(float)

    def _entries(self, ts) -> tuple:
        entry = current_entry()
        if entry is None:
            node = torch._C._current_autograd_node()
            entry = None if node is None else node.metadata.get("entry")
        if entry is not None:
            return (entry,)
        for t in ts:
            held = self.owners.get(t)
            if held:
                return held
        return (self.default,)

    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        for e in self._entries(()):
            self.flops[e] += flops
            self.kernel_flops[e] += flops
            self.bytes[e] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        lists = [a for a in args if isinstance(a, (list, tuple)) and a
                 and isinstance(a[0], torch.Tensor)]
        if lists and isinstance(out, (list, tuple)):  # a foreach op: position by position
            for i, o in enumerate(out):
                ins = [a[i] for a in lists if i < len(a)]
                held = self._entries(ins)
                self.owners[o] = held
                for e in held:
                    self.bytes[e] += _nbytes(ins + [o])
            return out
        ins = _tensors(args) + _tensors(list(kwargs.values()))
        outs = _tensors(out)
        held = self._entries(ins)
        for o in outs:
            self.owners.setdefault(o, held)
        if func.is_view or func in _FREE:
            return out
        fn = flop_counter.flop_registry.get(func._overloadpacket)
        flops = fn(*args, **kwargs, out_val=out) if fn is not None else 0
        for e in held:
            self.flops[e] += flops
            self.bytes[e] += _nbytes(ins + outs)
        return out


def _holders(tree, owners: WeakIdKeyDictionary, grid) -> dict:
    """Each entry's bytes of ``tree``'s blocks (a whole tensor is the one
    entry's of a 1x1 grid); records the tensors' holders."""
    per = defaultdict(int)
    held: dict = defaultdict(list)
    for _, leaf in tree_flatten_with_path(tree):
        blocks = leaf.tensors.items() if isinstance(leaf, Blocks) else (
            [((0,) * grid.devices.ndim, leaf)] if isinstance(leaf, torch.Tensor) else ())
        for idx, t in blocks:
            per[idx] += t.numel() * t.element_size()
            held[id(t)].append((t, idx))
    for entries in held.values():
        owners[entries[0][0]] = tuple(i for _, i in entries)
    return per


def state_specs(cfg: ArchConfig):
    """The train state as meta tensors (``init_params`` on meta, zero
    moments, a host rng pair)."""
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.step import TrainState

    params = T.init_params(cfg, generator=None, device="meta")
    return TrainState(params=params, opt=adamw_init(params),
                      rng=torch.zeros(2, dtype=torch.int64))


def _prefill(params, cfg: ArchConfig, batch: dict):
    """The reference's prefill step: the next-token logits [b, vocab] of
    the batch (each data row's last position gathered, not all of them;
    on a 1x1 grid too, so that grids of one shape compare)."""
    from repro_torch.distributed.context import active_grid, get_ctx, move

    rows, P, xs, _, _, _ = sharded.run_rows(params, cfg, batch["tokens"],
                                            batch.get("positions"),
                                            patch_embeds=batch.get("patch_embeds"),
                                            grid=active_grid() or get_ctx().mesh)
    first = rows[0]
    last = [sharded.gather_logits(row, cfg, sharded.head_rows(P, cfg, row, x[:, -1:]))[:, 0]
            for row, x in zip(rows, xs)]
    sharded.absent_rows(rows, last[0].numel() * last[0].element_size(), "data_gather")
    return torch.cat([move(t, row.idx[0], first.idx[0], first.grid, "data_gather")
                      for row, t in zip(rows, last)])


def decode_inputs(cfg: ArchConfig, shape: ShapeCfg) -> tuple[list, dict]:
    """The decode step's caches (``init_caches`` of the shape's batch and
    length, on meta) and its token and position stand-ins."""
    return (T.init_caches(cfg, shape.global_batch, shape.seq_len, device="meta"),
            decode_token_specs(cfg, shape))


def count_step(cfg: ArchConfig, shape: ShapeCfg, grid, *, symmetric: bool = True) -> dict:
    """Run ``shape``'s step (train, prefill or decode) on ``grid`` (entries
    on ``meta``) under the count; the per-entry numbers, the reported
    entry's and their maxima. ``symmetric`` runs only data row 0
    (``sharded.first_row_only``: every row does the same work; a decode
    whose caches split the sequence runs every row that holds a slice) and
    reports among its entries; ``tests/test_torch_dryrun.py`` holds it to
    the full loop on mini grids."""
    from repro_torch.training import make_schedule, make_train_step

    owners = WeakIdKeyDictionary()
    one = grid.devices.size == 1

    def lay(tree, how, **kw):  # a 1x1 grid runs the plain path, on whole leaves
        return tree if one else how(tree, grid, share="row", **kw)

    if shape.kind == "decode":
        caches, batch = decode_inputs(cfg, shape)
        caches = lay(caches, place_caches, batch=shape.global_batch)
        if not one:  # tokens and positions each by ``batch_shardings``, as the
            # reference's decode ``in_shardings`` (``dryrun.py:139-144``)
            batch = {k: lay_out(v, batch_shardings({k: v}, grid)[k], share="row")
                     for k, v in batch.items()}
        params = lay(T.init_params(cfg, generator=None, device="meta"), place)
        trees = (params, caches)
        run = lambda: T.decode_step(params, cfg, batch["tokens"], caches,  # noqa: E731
                                    batch["positions"])
    else:
        batch = input_specs(cfg, shape)
        batch = batch if one else place_batch(batch, grid)
        if shape.kind == "train":
            state = lay(state_specs(cfg), place_state)
            trees = (state.params, state.opt.mu, state.opt.nu)
            step = make_train_step(cfg, make_schedule(peak_lr=3e-4, warmup_steps=100,
                                                      total_steps=10_000))
            run = lambda: step(state, batch)  # noqa: E731
        else:
            params = lay(T.init_params(cfg, generator=None, device="meta"), place)
            trees = (params,)
            run = lambda: _prefill(params, cfg, batch)  # noqa: E731
    args = defaultdict(int)
    for tree in trees:
        for k, v in _holders(tree, owners, grid).items():
            args[k] += v
    # a train step's outputs are its new state; a decode step's its new caches
    outputs = defaultdict(int, dict(args) if shape.kind == "train" else
                          _holders(trees[-1], owners, grid) if shape.kind == "decode" else {})
    for k, v in _holders(batch, owners, grid).items():
        args[k] += v
    entries = grid_index_rows(grid)[0] if symmetric else list(np.ndindex(grid.devices.shape))
    counter = GridCount(entries[0], owners)
    reset_grid_stats()
    prev = _launch.META_COUNTER
    _launch.META_COUNTER = counter.kernel
    try:
        with use_mesh(grid), _Tag(), counter, (
                sharded.first_row_only() if symmetric else contextlib.nullcontext()):
            if shape.kind == "train":
                run()
            else:
                with torch.no_grad():
                    out = run()
    finally:
        _launch.META_COUNTER = prev
    if shape.kind != "train":  # the whole batch's logits, gathered on the first entry
        logits = out[0] if shape.kind == "decode" else out
        outputs[entries[0]] += logits.numel() * logits.element_size() * (
            shape.global_batch // logits.shape[0])
    received = defaultdict(lambda: defaultdict(int))
    for (idx, kind), n in GRID_STATS["received"].items():
        received[idx][kind] += n
    coll = {e: sum(received[e].values()) for e in entries}
    top = max(entries, key=lambda e: (counter.flops[e], -entries.index(e)))
    return {
        "entry": list(top),
        "flops": counter.flops[top],
        "kernel_flops": counter.kernel_flops[top],
        "bytes": counter.bytes[top],
        "collective_bytes": coll[top],
        "collectives": dict(received[top]),
        "memory": {"argument_bytes": args[top], "output_bytes": outputs.get(top, 0),
                   "temp_bytes": None},
        "max_over_entries": {
            "flops": max(counter.flops[e] for e in entries),
            "bytes": max(counter.bytes[e] for e in entries),
            "collective_bytes": max(coll.values()),
            "argument_bytes": max(args[e] for e in entries)},
        "entries": int(grid.devices.size),
        "entries_counted": len(entries),
        "grid_collectives": dict(GRID_STATS["bytes"]),
    }


def plan_argument_bytes(cfg: ArchConfig, shape: ShapeCfg, grid) -> int:
    """The most any entry holds of the plan's state (train: parameters and
    two moments; otherwise parameters), input blocks and, for decode, the
    caches and the token and position blocks."""
    params = T.init_params(cfg, generator=None, device="meta")
    per = defaultdict(int)

    def add(tree, plans, copies=1):
        for (_, leaf), (_, plan) in zip(tree_flatten_with_path(tree),
                                        tree_flatten_with_path(plans)):
            for idx, sl in plan.blocks(tuple(leaf.shape)).items():
                per[idx] += copies * int(np.prod([s.stop - s.start for s in sl])) \
                    * leaf.element_size()

    add(params, param_shardings(params, grid), 3 if shape.kind == "train" else 1)
    if shape.kind == "decode":
        caches, tok = decode_inputs(cfg, shape)
        add(caches, cache_shardings(caches, grid, batch=shape.global_batch))
        for k, v in tok.items():
            add({k: v}, batch_shardings({k: v}, grid))
    else:
        batch = input_specs(cfg, shape)
        add(batch, batch_shardings(batch, grid))
    return max(per.values())


def model_flops(cfg: ArchConfig, shape: ShapeCfg) -> float:
    """MODEL_FLOPS = 6·N_active·D (2· for prefill and decode), the
    reference's count: MoE expert stacks (rank-4 ``w_gate / w_up /
    w_down``) count top_k / n_experts of their parameters."""
    params = T.init_params(cfg, generator=None, device="meta")
    n_total = 0
    n_moe_all = 0
    for path, leaf in tree_flatten_with_path(params):
        names = path_names(path)
        if cfg.moe and any(n in ("w_gate", "w_up", "w_down") for n in names) \
                and leaf.dim() == 4:
            n_moe_all += leaf.numel()
        else:
            n_total += leaf.numel()
    n_active = n_total
    if cfg.moe and n_moe_all:
        n_active += n_moe_all * (cfg.moe.top_k / cfg.moe.n_experts)
    D = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6 if shape.kind == "train" else 2
    return mult * n_active * D


def roofline_terms(full: dict, cfg: ArchConfig, shape: ShapeCfg) -> dict:
    """The reported entry's counts priced at the port's H100 numbers."""
    terms = {"compute_s": full["flops"] / roofline.PEAK_FLOPS,
             "memory_s": full["bytes"] / roofline.HBM_BW,
             "collective_s": full["collective_bytes"] / NVLINK_BW}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k])
    mf = model_flops(cfg, shape)
    terms["model_flops"] = mf
    terms["useful_ratio"] = mf / (full["flops"] * full["entries"]) if full["flops"] else 0.0
    total = {k: full[k] for k in ("flops", "bytes", "collective_bytes")}
    parts = {"kernels": {"flops": full["kernel_flops"]},
             "aten": {"flops": full["flops"] - full["kernel_flops"]},
             "collectives": full["collectives"]}
    return {"total": total, "parts": parts, "terms": terms,
            "peaks": {"flops_per_s": roofline.PEAK_FLOPS, "hbm_bytes_per_s": roofline.HBM_BW,
                      "link_bytes_per_s": NVLINK_BW}}


def run_one(arch: str, shape_name: str, *, multi_pod: bool, roofline: bool,
            grid=None) -> dict:
    """One (arch, shape, grid) record; ``grid`` defaults to the production
    grid of meta entries."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    grid = grid or make_production_mesh(multi_pod=multi_pod,
                                        devices=["meta"] * (512 if multi_pod else 256))
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(str(s) for s in grid.devices.shape)}
    ok, why = shape_supported(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    try:
        rec["full"] = count_step(cfg, shape, grid)
        rec["status"] = "ok"
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        return rec
    if roofline:
        rec["roofline"] = roofline_terms(rec["full"], cfg, shape)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--roofline", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = all_arch_names() if args.all else [args.arch]
    shapes = list(SHAPES) if args.all else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]
    out_f = open(args.out, "a") if args.out else None
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                t0 = time.time()
                rec = run_one(arch, shape_name, multi_pod=mp, roofline=args.roofline)
                rec["wall_s"] = round(time.time() - t0, 1)
                line = json.dumps(rec)
                print(f"[{rec['status']:>12}] {arch} {shape_name} {rec['mesh']} "
                      f"({rec['wall_s']}s)"
                      + (f" err={rec.get('error', '')}" if rec["status"] == "error" else ""),
                      flush=True)
                print(line, flush=True)
                if out_f:
                    out_f.write(line + "\n")
                    out_f.flush()
    if out_f:
        out_f.close()


if __name__ == "__main__":
    main()
