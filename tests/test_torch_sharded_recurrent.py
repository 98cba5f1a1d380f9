"""The recurrent mixers' train step run by the sharding plan across a grid
(``models.sharded``: rwkv6's time mix and channel mix, hymba's attention
and SSM branches), on grids of "cpu" entries, against the 1x1 grid and
against the reference's jitted step on an Auto-axis (2, 2) mesh of forced
host devices.

- rwkv6's smoke config (8 WKV heads of 32) and a hymba with VQT whose 6
  heads the plan cuts at M = 4 (1.5 an entry) and whose second layer is
  windowed (16 tokens), so the SSM heads, the conv's ``x | z`` columns and
  the GQA mapping cross the model blocks.
- Each grid's loss lies within 1e-5 of the 1x1 grid's and every reduced,
  reassembled gradient leaf within 1e-4 of its max. A placed step's
  metrics (loss, gradient norm) lie within 1e-5 of the 1x1 step's and
  every replica is bitwise equal after it. Its update of each leaf (the
  new leaf less the old) lies within half the learning rate of the 1x1
  step's in every element and within 1% of it in norm. AdamW divides by
  the root of the second moment, so an element whose gradient is near
  zero moves by an amount that scales the grids' float differences up
  (rwkv6's updates differ by up to 0.09 of the learning rate), while a
  step moves an element by about the learning rate: a leaf left as it
  was fails the element bound, one updated from half its gradient the
  norm bound.
- The launcher places and steps both families on a grid.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.common.pytree import tree_flatten_with_path, tree_unflatten  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.context import (  # noqa: E402
    GRID_STATS, Blocks, reduce_replicas, reset_grid_stats, use_mesh,
)
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.sharding import place, place_state, unplace  # noqa: E402
from repro_torch.models.transformer import init_params, params_from_numpy  # noqa: E402
from repro_torch.training import make_schedule, make_train_step, train_state_init  # noqa: E402
from repro_torch.training.step import lm_loss, value_and_grad  # noqa: E402
from test_torch_sharded_train import (  # noqa: E402
    GRIDS, LEAF_TOL, LOSS_TOL, _batch, _close, _flat, _grid,
)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["rwkv6-7b", "hymba-1.5b"]
UPDATE_LR_TOL, UPDATE_NORM_TOL = 0.5, 1e-2  # of the learning rate; of the update's norm


def _cfg(arch: str):
    cfg = get_config(arch, smoke=True, vqt=True)
    if arch == "hymba-1.5b":  # heads cut at M = 4; a windowed second layer
        local = dataclasses.replace(cfg.stages[1][0][0], window=16)
        cfg = dataclasses.replace(cfg, n_heads=6,
                                  stages=(cfg.stages[0], ((local,), 1))).validate()
    return cfg


@pytest.fixture(scope="module")
def warm():
    """{arch: (cfg, a state after one 1x1 step, batch, the 1x1 loss and
    gradients there, the 1x1 step's parameters and metrics)}."""
    out = {}
    sched = make_schedule(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    for arch in ARCHS:
        cfg = _cfg(arch)
        state = train_state_init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        batch = _batch(cfg)
        step = make_train_step(cfg, sched)
        with use_mesh(make_host_mesh("cpu")):
            state, _ = step(state, batch)
            loss, _, grads = value_and_grad(lm_loss, state.params, cfg, batch,
                                            torch.Generator().manual_seed(5))
            after, metrics = step(state, batch)
        out[arch] = (cfg, state, batch, float(loss), _flat(grads), _flat(after.params), metrics)
    return out


@pytest.mark.parametrize("shape,axes", GRIDS, ids=lambda g: "x".join(map(str, g))
                         if isinstance(g[0], int) else None)
@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_gradients_match_the_1x1_grid(warm, arch, shape, axes):
    cfg, state, batch, loss0, grads0, _, _ = warm[arch]
    grid = _grid(shape, axes)
    reset_grid_stats()
    with use_mesh(grid):
        loss, _, grads = value_and_grad(lm_loss, place(state.params, grid), cfg, batch,
                                        torch.Generator().manual_seed(5))
        grads = reduce_replicas(grads)
    assert abs(float(loss) - loss0) <= LOSS_TOL * max(1.0, abs(loss0))
    _close(_flat(unplace(grads)), grads0, LEAF_TOL, f"{arch} {shape} gradient")
    if grid.shape["model"] > 1:  # the heads' columns cross the model blocks
        assert GRID_STATS["bytes"]["model_gather"] > 0


@pytest.mark.parametrize("shape,axes", [GRIDS[2], GRIDS[5]], ids=["2x2", "2x2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_placed_step_keeps_replicas_equal(warm, arch, shape, axes):
    cfg, state, batch, _, _, after0, metrics0 = warm[arch]
    grid = _grid(shape, axes)
    step = make_train_step(cfg, make_schedule(peak_lr=1e-3, warmup_steps=1, total_steps=10))
    with use_mesh(grid):
        new, metrics = step(place_state(state, grid, share=False), batch)
    for k in ("lm_loss", "aux_loss", "grad_norm"):
        assert abs(float(metrics[k]) - float(metrics0[k])) <= LOSS_TOL * max(
            1.0, abs(float(metrics0[k]))), k
    before, got, lr = _flat(state.params), _flat(unplace(new.params)), float(metrics0["lr"])
    assert set(got) == set(after0)
    for k, w in after0.items():
        want, delta = w - before[k], got[k] - before[k]
        assert float((delta - want).abs().max()) <= UPDATE_LR_TOL * lr, f"{arch} {shape} {k}"
        assert float((delta - want).norm()) <= UPDATE_NORM_TOL * float(want.norm()), k
    for tree in (new.params, new.opt.mu, new.opt.nu):
        for _, leaf in tree_flatten_with_path(tree):
            assert isinstance(leaf, Blocks)
            for held in leaf.replicas():
                assert len(held) >= 2
                assert all(torch.equal(held[0][1], t) for _, t in held[1:])


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_steps_the_recurrent_families_on_a_grid(warm, arch):
    """``launch.train``'s placement and grid step: a (1, 2) grid of the
    launcher's state steps as the 1x1 grid does."""
    from repro_torch.launch import train

    cfg, state, batch, *_ = warm[arch]
    sched = make_schedule(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    grid = _grid((1, 2), ("data", "model"))
    got, m = train.grid_step(make_train_step(cfg, sched), grid)(
        train.place_for(state, cfg, grid), batch)
    want, m0 = train.grid_step(make_train_step(cfg, sched), make_host_mesh("cpu"))(state, batch)
    for k in ("lm_loss", "grad_norm"):
        assert abs(float(m[k]) - float(m0[k])) <= LOSS_TOL * max(1.0, abs(float(m0[k]))), k
    assert all(isinstance(leaf, Blocks) for _, leaf in tree_flatten_with_path(got.params))


REF_STEP = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    sys.path.insert(0, sys.argv[3])
    from _torch_parity import params_to_numpy
    from repro.configs import get_config
    from repro.distributed.context import use_mesh
    from repro.launch.sharding import batch_shardings, param_shardings
    from repro.models import transformer as T
    from repro.training.step import _lm_loss_fn

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k in sorted(tree) for k2, v2 in flat(tree[k], f"{prefix}{k}/").items()}
        if isinstance(tree, (list, tuple)):
            return {k2: v2 for i, x in enumerate(tree) for k2, v2 in flat(x, f"{prefix}{i}/").items()}
        return {prefix[:-1]: np.asarray(tree)}

    data = dict(np.load(sys.argv[1]))
    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    out = {}
    for arch in ("rwkv6-7b", "hymba-1.5b"):
        cfg = get_config(arch, smoke=True, vqt=True)
        params = T.init_params(jax.random.PRNGKey(1), cfg)
        batch = {k.split("/", 1)[1]: jnp.asarray(v) for k, v in data.items()
                 if k.startswith(arch + "/")}
        rng = jax.random.PRNGKey(7)
        b, n = batch["tokens"].shape
        g = 0
        for pattern, repeat in cfg.stages:
            for _ in range(repeat):
                for pi, _l in enumerate(pattern):
                    if cfg.vqt is not None:
                        key = jax.random.fold_in(rng, (g - pi) * 8 + pi)
                        out[f"{arch}/noise/{g}"] = np.asarray(jax.random.gumbel(
                            key, (b, n, cfg.vqt.n_heads, cfg.vqt.codebook_size)))
                    g += 1
        with use_mesh(mesh):
            f = jax.jit(lambda p, bt, r: jax.value_and_grad(_lm_loss_fn, has_aux=True)(
                            p, cfg, bt, r),
                        in_shardings=(param_shardings(params, mesh),
                                      batch_shardings(batch, mesh), None))
            (loss, _), grads = f(params, batch, rng)
        out[f"{arch}/loss"] = np.asarray(loss)
        for k, v in flat(params_to_numpy(jax.device_get(params))).items():
            out[f"{arch}/param/{k}"] = v
        for k, v in flat(params_to_numpy(jax.device_get(grads))).items():
            out[f"{arch}/grad/{k}"] = v
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def reference_step(tmp_path_factory):
    """The reference's loss and gradients of the two smoke configs on an
    Auto (2, 2) mesh of 4 forced host devices (one subprocess), with its
    weights, batch and noise."""
    d = tmp_path_factory.mktemp("ref_recurrent")
    feed = {}
    for arch in ARCHS:
        feed.update({f"{arch}/{k}": v.numpy()
                     for k, v in _batch(get_config(arch, smoke=True, vqt=True)).items()})
    np.savez(d / "in.npz", **feed)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", REF_STEP, str(d / "in.npz"), str(d / "out.npz"),
                           str(ROOT / "tests")], capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("arch", ARCHS)
def test_2x2_recurrent_step_matches_the_references_sharded_step(reference_step, arch):
    """The port's (2, 2) grid, its parameters placed, against the
    reference's jitted ``value_and_grad`` under ``param_shardings``: the
    same weights and noise; the loss within 1e-5, every gradient leaf
    within 1e-4 of its max."""
    ref = reference_step
    cfg = get_config(arch, smoke=True, vqt=True)
    like = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    names = list(_flat(like))
    params = params_from_numpy(tree_unflatten(
        like, [torch.tensor(ref[f"{arch}/param/{k}"]) for k in names]), device="cpu")
    noise = ([ref[f"{arch}/noise/{i}"] for i in range(cfg.n_layers)]
             if cfg.vqt is not None else None)
    grid = _grid((2, 2), ("data", "model"))
    with use_mesh(grid):
        loss, _, grads = value_and_grad(lm_loss, place(params, grid), cfg, _batch(cfg), None,
                                        vq_noise=noise)
        grads = unplace(reduce_replicas(grads))
    want = float(ref[f"{arch}/loss"])
    assert abs(float(loss) - want) <= LOSS_TOL * max(1.0, abs(want))
    _close(_flat(grads), {k: ref[f"{arch}/grad/{k}"] for k in names}, LEAF_TOL,
           f"{arch} vs the reference")
