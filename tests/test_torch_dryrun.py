"""``repro_torch.launch.dryrun``: the port's sharded step on grids of
``meta`` entries — the counterpart of the reference's
``tests/test_sharding.py::test_mini_dryrun_subprocess``.

- The dry run executes on (2, 4) and (2, 2, 2) meta grids for
  deepseek-v2's and VQ-OPT's smoke configs at train and prefill, and for
  one family a cache kind (phi4-mini, deepseek-v2, hymba, rwkv6) at
  decode with the batch split (8) and the sequence split (1), and the
  recurrent two at train and prefill.
- ``model_flops`` equals the reference's on every registry arch and
  ``SHAPES`` entry; ``argument_bytes`` equals what the reference's plan
  puts on a device (its ``param_shardings`` / ``batch_shardings`` /
  ``cache_shardings`` on an Auto-axis mesh of 8 forced host devices, one
  subprocess; decode in f32 / int32, 4 B an element).
- The counts behave as a plan's should: a (k, 1) grid's entry does 1/k of
  the 1x1 FLOPs; on a (1, M) grid each entry of a plan that splits every
  product does 1/M; running data row 0 alone (the symmetry ``--all``
  uses) gives the full loop's numbers for row 0's entries.
The reference's ``cost_analysis`` FLOPs on the mini meshes are printed
beside the port's (no gate: XLA counts its own program).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import all_arch_names, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.specs import SHAPES, ShapeCfg  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MINI = {"2x4": ((2, 4), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
TRAIN, PREFILL = ShapeCfg("mini", "train", 32, 8), ShapeCfg("mini", "prefill", 32, 8)


def _meta(shape, axes=("data", "model")):
    return make_mesh(shape, axes, ["meta"] * int(np.prod(shape)))


REF = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    from functools import partial
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    jax.devices()  # the 8 devices, before repro.launch.dryrun sets its own flags
    from repro.configs import get_config
    from repro.distributed.context import use_mesh
    from repro.launch import dryrun
    from repro.launch.sharding import batch_shardings, param_shardings
    from repro.launch.specs import SHAPES
    from repro.training import make_schedule, make_train_step, train_state_init

    archs = json.loads(sys.argv[1])
    out = {"model_flops": {}, "argument_bytes": {}, "flops": {}, "decode_bytes": {},
           "recurrent_train_bytes": {}}

    def plan_bytes(per, tree, plan, itemsize=None):
        for leaf, sh in zip(jax.tree.leaves(tree), jax.tree.leaves(plan)):
            for dev, idx in sh.devices_indices_map(leaf.shape).items():
                n = 1
                for sl, dim in zip(idx, leaf.shape):
                    n *= len(range(*sl.indices(dim)))
                per[dev.id] = per.get(dev.id, 0) + n * (itemsize or leaf.dtype.itemsize)

    for a in archs:
        for s in SHAPES:
            out["model_flops"][f"{a}/{s}"] = dryrun.model_flops(get_config(a), SHAPES[s])
    from repro.launch.sharding import cache_shardings
    from repro.models import transformer as T

    for axes, shape in [(("data", "model"), (2, 4)), (("pod", "data", "model"), (2, 2, 2))]:
        mesh = jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))
        tag = "x".join(map(str, shape))
        for arch in ("deepseek-v2-236b", "vq-opt-125m"):
            cfg = get_config(arch, smoke=True)
            with use_mesh(mesh):
                state = jax.eval_shape(partial(train_state_init, cfg=cfg), jax.random.PRNGKey(0))
                batch = {"tokens": jax.ShapeDtypeStruct((8, 32), jnp.int32)}
                if cfg.pos in ("learned", "sampled"):
                    batch["positions"] = jax.ShapeDtypeStruct((8, 32), jnp.int32)
                per = {}
                for tree, plan in ((state.params, param_shardings(state.params, mesh)),
                                   (state.opt.mu, param_shardings(state.opt.mu, mesh)),
                                   (state.opt.nu, param_shardings(state.opt.nu, mesh)),
                                   (batch, batch_shardings(batch, mesh))):
                    for leaf, sh in zip(jax.tree.leaves(tree), jax.tree.leaves(plan)):
                        for dev, idx in sh.devices_indices_map(leaf.shape).items():
                            n = 1
                            for sl, dim in zip(idx, leaf.shape):
                                n *= len(range(*sl.indices(dim)))
                            per[dev.id] = per.get(dev.id, 0) + n * leaf.dtype.itemsize
                out["argument_bytes"][f"{arch}/{tag}"] = max(per.values())
                step = make_train_step(cfg, make_schedule(peak_lr=1e-3, warmup_steps=1,
                                                          total_steps=10))
                ca = jax.jit(step, in_shardings=(param_shardings(state, mesh),
                                                 batch_shardings(batch, mesh))
                             ).lower(state, batch).compile().cost_analysis()
                if isinstance(ca, (list, tuple)):
                    ca = ca[0]
                out["flops"][f"{arch}/{tag}"] = float(ca.get("flops", 0))
        for arch in ("phi4-mini-3.8b", "deepseek-v2-236b", "hymba-1.5b", "rwkv6-7b"):
            cfg = get_config(arch, smoke=True)
            with use_mesh(mesh):
                params = jax.eval_shape(lambda: T.init_params(jax.random.PRNGKey(0), cfg))
                for b in (8, 1):
                    caches = jax.eval_shape(lambda: T.init_caches(cfg, b, 64, dtype=jnp.float32))
                    per = {}
                    plan_bytes(per, params, param_shardings(params, mesh), 4)
                    plan_bytes(per, caches, cache_shardings(caches, mesh, batch=b), 4)
                    for k in ("tokens", "positions"):
                        tok = {k: jax.ShapeDtypeStruct((b, 1), jnp.int32)}
                        plan_bytes(per, tok, batch_shardings(tok, mesh), 4)
                    out["decode_bytes"][f"{arch}/{tag}/{b}"] = max(per.values())
                if arch in ("hymba-1.5b", "rwkv6-7b"):
                    batch = {"tokens": jax.ShapeDtypeStruct((8, 32), jnp.int32)}
                    per = {}
                    for _ in range(3):  # parameters and the two AdamW moments
                        plan_bytes(per, params, param_shardings(params, mesh), 4)
                    plan_bytes(per, batch, batch_shardings(batch, mesh))
                    out["recurrent_train_bytes"][f"{arch}/{tag}"] = max(per.values())
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference():
    """The reference's model_flops (every arch and shape), its plans' bytes
    a device and its compiled mini steps' FLOPs, in one subprocess."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", REF, json.dumps(all_arch_names())],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", [TRAIN, PREFILL], ids=["train", "prefill"])
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "vq-opt-125m"])
@pytest.mark.parametrize("grid", list(MINI))
def test_dry_run_executes_on_meta_grids(arch, kind, grid):
    shape, axes = MINI[grid]
    full = dryrun.count_step(get_config(arch, smoke=True, vqt=True), kind, _meta(shape, axes))
    assert full["flops"] > 0 and full["bytes"] > 0 and full["collective_bytes"] > 0
    assert full["collectives"]["model_sum"] > 0
    if arch == "vq-opt-125m":  # the σ kernel (and at prefill vq_assign) on meta
        assert full["kernel_flops"] > 0


def test_model_flops_equal_the_references(reference):
    for arch in all_arch_names():
        for s in SHAPES:
            assert dryrun.model_flops(get_config(arch), SHAPES[s]) == pytest.approx(
                reference["model_flops"][f"{arch}/{s}"], rel=1e-12), (arch, s)


@pytest.mark.parametrize("grid", list(MINI))
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "vq-opt-125m"])
def test_argument_bytes_equal_the_references_plan(reference, arch, grid):
    """The plan's state and batch a device, in the port's f32 / int32:
    the most any entry holds, against the reference's most."""
    shape, axes = MINI[grid]
    cfg = get_config(arch, smoke=True)
    full = dryrun.count_step(cfg, TRAIN, _meta(shape, axes))
    assert full["memory"]["argument_bytes"] == reference["argument_bytes"][f"{arch}/{grid}"]
    assert full["max_over_entries"]["argument_bytes"] == full["memory"]["argument_bytes"]
    print(f"{arch} {grid}: FLOPs a device, the port {full['flops']:.4g}, "
          f"the reference's cost_analysis {reference['flops'][f'{arch}/{grid}']:.4g}")


@pytest.mark.parametrize("arch", ["vq-opt-125m", "deepseek-v2-236b"])
def test_data_rows_split_the_flops(arch):
    cfg = get_config(arch, smoke=True, vqt=True)
    one = dryrun.count_step(cfg, TRAIN, _meta((1, 1)))["flops"]
    for k in (2, 4):
        assert dryrun.count_step(cfg, TRAIN, _meta((k, 1)), symmetric=False)["flops"] * k == one


def test_the_model_axis_splits_the_products():
    """phi4-mini's smoke prefill (no VQ): every product splits, so each
    entry of a (1, M) grid does 1/M of the 1x1 FLOPs."""
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    one = dryrun.count_step(cfg, PREFILL, _meta((1, 1)))["flops"]
    for M in (2, 4):
        full = dryrun.count_step(cfg, PREFILL, _meta((1, M)))
        assert full["flops"] * M == one
        assert full["max_over_entries"]["flops"] == full["flops"]


@pytest.mark.parametrize("kind", [TRAIN, PREFILL], ids=["train", "prefill"])
@pytest.mark.parametrize("grid", list(MINI))
def test_row_symmetry_gives_the_full_loops_numbers(grid, kind):
    """Data row 0 alone against every row, for row 0's entries: the same
    FLOPs, collectives and argument bytes; bytes but for the first entry's
    combine over the rows' outputs (a few scalars, the gathered logits)."""
    shape, axes = MINI[grid]
    cfg = get_config("deepseek-v3-671b", smoke=True, vqt=True)
    a = dryrun.count_step(cfg, kind, _meta(shape, axes), symmetric=False)
    b = dryrun.count_step(cfg, kind, _meta(shape, axes), symmetric=True)
    for k in ("entry", "flops", "kernel_flops", "collective_bytes", "collectives", "memory"):
        assert a[k] == b[k], k
    assert abs(a["bytes"] - b["bytes"]) <= 2e-3 * a["bytes"]


DECODE = {"b8": ShapeCfg("mini", "decode", 64, 8), "b1": ShapeCfg("mini", "decode", 64, 1)}
CACHE_ARCHS = ["phi4-mini-3.8b", "deepseek-v2-236b", "hymba-1.5b", "rwkv6-7b"]


@pytest.mark.parametrize("batch", list(DECODE))
@pytest.mark.parametrize("grid", list(MINI))
@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_decode_executes_with_the_references_argument_bytes(reference, arch, grid, batch):
    """A decode step on the meta grid, its caches placed by their plan (a
    batch of 8 splits over the data rows; a batch of 1 splits the
    sequence): FLOPs, bytes and collectives counted; the plan's
    parameters, caches, tokens and positions a device equal the
    reference's."""
    shape, axes = MINI[grid]
    cfg = get_config(arch, smoke=True)
    full = dryrun.count_step(cfg, DECODE[batch], _meta(shape, axes))
    assert full["flops"] > 0 and full["bytes"] > 0 and full["collective_bytes"] > 0
    want = reference["decode_bytes"][f"{arch}/{grid}/{batch[1:]}"]
    assert full["memory"]["argument_bytes"] == want
    assert dryrun.plan_argument_bytes(cfg, DECODE[batch], _meta(shape, axes)) == want
    if batch == "b1" and arch != "rwkv6-7b":  # attention over the sequence rows
        assert full["collectives"]["seq_combine"] > 0


@pytest.mark.parametrize("kind", [TRAIN, PREFILL], ids=["train", "prefill"])
@pytest.mark.parametrize("grid", list(MINI))
@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-7b"])
def test_recurrent_archs_execute(reference, arch, grid, kind):
    shape, axes = MINI[grid]
    cfg = get_config(arch, smoke=True)
    full = dryrun.count_step(cfg, kind, _meta(shape, axes))
    assert full["flops"] > 0 and full["collectives"]["model_sum"] > 0
    if kind is TRAIN:
        want = reference["recurrent_train_bytes"][f"{arch}/{grid}"]
        assert full["memory"]["argument_bytes"] == want
        assert dryrun.plan_argument_bytes(cfg, kind, _meta(shape, axes)) == want


def test_symmetric_decode_gives_the_full_loops_numbers():
    """The batch split's rows do the same work: data row 0 alone gives
    the full loop's FLOPs and collectives for row 0's entries; under the
    sequence split every row that holds a slice runs either way."""
    cfg = get_config("hymba-1.5b", smoke=True, vqt=True)
    for kind in DECODE.values():
        a = dryrun.count_step(cfg, kind, _meta((2, 4)), symmetric=False)
        b = dryrun.count_step(cfg, kind, _meta((2, 4)), symmetric=True)
        for k in ("entry", "flops", "kernel_flops", "collectives", "memory"):
            assert a[k] == b[k], (kind.global_batch, k)


def test_cli_prints_a_record(capsys):
    dryrun.main(["--arch", "rwkv6-7b", "--shape", "long_500k", "--multi-pod"])
    lines = capsys.readouterr().out.splitlines()
    rec = json.loads(lines[-1])
    assert rec["mesh"] == "2x16x16" and rec["status"] == "ok"
    assert set(rec) >= {"arch", "shape", "status", "full", "wall_s"}
    assert rec["full"]["flops"] > 0 and rec["full"]["memory"]["argument_bytes"] > 0
