"""The port's train step and forward run by the sharding plan across a grid
(``models.sharded``, ``launch.sharding.place_state``), on grids of "cpu"
entries, against the same step on the 1x1 grid and against the reference's
jitted step on an Auto-axis (2, 2) mesh of forced host devices.

- Every attention-stack family's smoke config with VQT: VQ-OPT (σ, VQ
  heads spanning model blocks), phi4-mini (GQA 4 : 2 heads, RoPE),
  gemma3 (sliding windows, softmax), deepseek-v2 (MLA + MoE) and
  deepseek-v3 (MTP). MoE layers compare with the 1x1 grid at a capacity
  where nothing drops and with the aux weight 0: expert parallelism's aux
  is the mean of its slices' by design (ROADMAP Queue C item 2), which
  the reference comparison holds at the default capacity.
- Each grid's gradients (reduced over the replicas, reassembled) lie
  within 1e-4 of each leaf's max of the 1x1 grid's, the loss within 1e-5;
  after a step every leaf likewise, each block is the slice ``blocks()``
  names, and the copies of a replicated leaf are bitwise equal (the state
  placed with one copy an entry, as on a grid of distinct cards).
- The plan really splits: q, the FFN hidden and the vocab on every grid
  with a model axis, and a kv head cut in two on one.
The recurrent families' steps are ``test_torch_sharded_recurrent.py``'s.
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

from repro_torch.common.pytree import path_names, tree_flatten_with_path  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticCorpus, lm_batches  # noqa: E402
from repro_torch.distributed.context import (  # noqa: E402
    GRID_STATS, Blocks, reduce_replicas, reset_grid_stats, use_mesh,
)
from repro_torch.launch.mesh import make_host_mesh, make_mesh  # noqa: E402
from repro_torch.launch.sharding import place, place_state, unplace  # noqa: E402
from repro_torch.models.transformer import forward, params_from_numpy  # noqa: E402
from repro_torch.training import make_schedule, make_train_step, train_state_init  # noqa: E402
from repro_torch.training.step import lm_loss, value_and_grad  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["vq-opt-125m", "phi4-mini-3.8b", "gemma3-12b", "deepseek-v2-236b", "deepseek-v3-671b"]
GRIDS = [((1, 2), ("data", "model")), ((2, 1), ("data", "model")), ((2, 2), ("data", "model")),
         ((1, 4), ("data", "model")), ((2, 4), ("data", "model")),
         ((2, 2, 2), ("pod", "data", "model"))]
B, N = 4, 32
LOSS_TOL, LEAF_TOL = 1e-5, 1e-4


def _cfg(arch: str):
    cfg = get_config(arch, smoke=True, vqt=True)
    if cfg.moe:  # nothing drops; EP's aux (a mean over slices) weighs 0
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k, aux_loss_weight=0.0))
    return cfg


def _grid(shape, axes):
    return make_mesh(shape, axes, ["cpu"] * int(np.prod(shape)))


def _batch(cfg, b=B, n=N, seed=0):
    batch = next(lm_batches(SyntheticCorpus(vocab=cfg.vocab, seed=seed), batch=b, seq_len=n,
                            steps=1, pos_pool=cfg.pos_pool if cfg.pos == "sampled" else None))
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _flat(tree) -> dict:
    return {"/".join(path_names(p)): v for p, v in tree_flatten_with_path(tree)}


def _close(got: dict, want: dict, rel: float, what: str) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        w = torch.as_tensor(w)
        scale = max(float(w.abs().max()), 1e-12)
        err = float((torch.as_tensor(got[k]) - w).abs().max())
        assert err <= rel * scale, f"{what} {k}: {err} of max {scale}"


@pytest.fixture(scope="module")
def warm():
    """{arch: (cfg, a state after one 1x1 step, batch, the 1x1 loss and
    gradients at that state, the 1x1 step's state and metrics)}. A
    warmed state makes the AdamW update a smooth function of the
    gradient (the first step's is its sign)."""
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
def test_grid_gradients_match_the_1x1_grid(warm, arch, shape, axes):
    """Placed parameters: the loss and every reduced, reassembled gradient
    leaf of the grid's ``lm_loss`` equal the 1x1 grid's (the same noise:
    the global draw sliced to the rows)."""
    cfg, state, batch, loss0, grads0, _, _ = warm[arch]
    grid = _grid(shape, axes)
    params = place(state.params, grid)
    reset_grid_stats()
    with use_mesh(grid):
        loss, _, grads = value_and_grad(lm_loss, params, cfg, batch,
                                        torch.Generator().manual_seed(5))
        grads = reduce_replicas(grads)
    assert abs(float(loss) - loss0) <= LOSS_TOL * max(1.0, abs(loss0))
    _close(_flat(unplace(grads)), grads0, LEAF_TOL, f"{arch} {shape} gradient")
    moved = GRID_STATS["bytes"]
    if grid.shape["model"] > 1:
        assert moved["model_sum"] > 0 and moved["model_bcast"] > 0
    if grid.devices.size // grid.shape["model"] > 1:
        assert moved["data_sum"] > 0


@pytest.mark.parametrize("shape,axes", [GRIDS[2], GRIDS[5]], ids=["2x2", "2x2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_grid_step_matches_the_1x1_step_and_keeps_replicas_equal(warm, arch, shape, axes):
    """The train step on a state placed with one copy an entry: metrics
    within 1e-5 of the 1x1 step's, each updated leaf within 1e-4 of its
    max, each block the slice its plan names, every replica bitwise
    equal."""
    cfg, state, batch, _, _, after0, metrics0 = warm[arch]
    grid = _grid(shape, axes)
    placed = place_state(state, grid, share=False)
    step = make_train_step(cfg, make_schedule(peak_lr=1e-3, warmup_steps=1, total_steps=10))
    with use_mesh(grid):
        new, metrics = step(placed, batch)
    for k in ("lm_loss", "aux_loss", "grad_norm", "lr"):
        assert abs(float(metrics[k]) - float(metrics0[k])) <= LOSS_TOL * max(
            1.0, abs(float(metrics0[k]))), k
    whole = _flat(unplace(new.params))
    _close(whole, after0, LEAF_TOL, f"{arch} {shape} updated")
    for tree in (new.params, new.opt.mu, new.opt.nu):
        for path, leaf in tree_flatten_with_path(tree):
            assert isinstance(leaf, Blocks)
            full = leaf.assemble()
            for idx, sl in leaf.sharding.blocks(leaf.shape).items():
                assert torch.equal(leaf.tensors[idx], full[sl])
            for held in leaf.replicas():  # every leaf is replicated over the data rows
                assert len(held) >= 2
                assert all(torch.equal(held[0][1], t) for _, t in held[1:]), path_names(path)


def _split(leaf) -> bool:
    """Whether ``leaf``'s plan splits a dimension over "model"."""
    return any("model" in (e if isinstance(e, tuple) else (e,))
               for e in leaf.sharding.spec if e is not None)


def test_the_plan_really_splits(warm):
    """With a model axis, q, the FFN hidden and the vocab are split on
    every grid; a kv head is cut between blocks somewhere (phi4-mini's
    smoke kv heads: 2 of 64 columns, on a model axis of 4)."""
    cut = []
    for arch in ARCHS:
        cfg, state, *_ = warm[arch]
        dh = cfg.resolved_head_dim
        for shape, axes in GRIDS:
            grid = _grid(shape, axes)
            M = grid.shape["model"]
            if M == 1:
                continue
            p = place(state.params, grid)
            layer = p["stages"][0][0]
            mixer, ffn = layer["mixer"], layer["ffn"]
            q = mixer["wq"] if "wq" in mixer else mixer["w_uq"]
            assert _split(q), (arch, shape)
            assert _split(ffn["w_up"]), (arch, shape)
            vocab = p.get("lm_head", p["embed"]["tok"])
            assert _split(vocab) and _split(p["embed"]["tok"])
            if "wk" in mixer:
                cols = mixer["wk"].shape[-1] // M
                if cols % dh:
                    cut.append((arch, shape, cols))
    assert cut, "no grid cut a kv head"


def test_forward_under_a_grid_matches_the_1x1_forward(warm):
    """Inference under (2, 2): logits (the VQ through ``vq_assign`` on
    each row) and deepseek-v3's MTP logits equal the 1x1 forward's."""
    for arch in ("vq-opt-125m", "deepseek-v3-671b"):
        cfg, state, batch, *_ = warm[arch]
        with torch.no_grad():
            want, aux0 = forward(state.params, cfg, batch["tokens"], batch.get("positions"))
            with use_mesh(_grid((2, 2), ("data", "model"))):
                got, aux = forward(state.params, cfg, batch["tokens"], batch.get("positions"))
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)
        if cfg.mtp:
            torch.testing.assert_close(aux["mtp_logits"], aux0["mtp_logits"], atol=2e-5,
                                       rtol=1e-5)


def test_accumulation_under_a_grid(warm):
    """``accum_steps = 2`` under a (2, 2) grid equals it under 1x1."""
    cfg, state, batch, *_ = warm["phi4-mini-3.8b"]
    sched = make_schedule(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, sched, accum_steps=2)
    with use_mesh(make_host_mesh("cpu")):
        want, m0 = step(state, batch)
    grid = _grid((2, 2), ("data", "model"))
    with use_mesh(grid):
        got, m = step(place_state(state, grid), batch)
    assert abs(float(m["lm_loss"]) - float(m0["lm_loss"])) <= LOSS_TOL * float(m0["lm_loss"])
    _close(_flat(unplace(got.params)), _flat(want.params), LEAF_TOL, "accum")


def test_host_mesh_is_the_plain_step_bit_for_bit(capsys):
    """``launch.train --mesh host`` runs the 1x1 grid: the plain path, so
    its step equals the step under no grid bitwise."""
    from repro_torch.launch import train

    cfg = get_config("vq-opt-125m", smoke=True)
    sched = make_schedule(peak_lr=1e-3, warmup_steps=1, total_steps=4)
    batch = _batch(cfg)
    init = lambda: train_state_init(cfg, generator=torch.Generator().manual_seed(0),  # noqa: E731
                                    device="cpu")
    grid = train.make_grid("host", "cpu")
    state = train.place_for(init(), cfg, grid)
    a, ma = train.grid_step(make_train_step(cfg, sched), grid)(state, batch)
    b, mb = make_train_step(cfg, sched)(init(), batch)
    assert float(ma["lm_loss"]) == float(mb["lm_loss"])
    for (_, x), (_, y) in zip(tree_flatten_with_path(a.params), tree_flatten_with_path(b.params)):
        assert torch.equal(x, y)


REF_STEP = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
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
    for arch in ("vq-opt-125m", "deepseek-v2-236b"):
        cfg = get_config(arch, smoke=True, vqt=True)
        if cfg.moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_shared=0))
        params = T.init_params(jax.random.PRNGKey(1), cfg)
        batch = {k.split("/", 1)[1]: jnp.asarray(v) for k, v in data.items()
                 if k.startswith(arch + "/")}
        rng = jax.random.PRNGKey(7)
        b, n = batch["tokens"].shape
        g = 0
        for pattern, repeat in cfg.stages:
            for _ in range(repeat):
                for pi, _l in enumerate(pattern):
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
REF_ARCHS = ("vq-opt-125m", "deepseek-v2-236b")


@pytest.fixture(scope="module")
def reference_step(tmp_path_factory):
    """The reference's loss and gradients on an Auto (2, 2) mesh of 4
    forced host devices (one subprocess), with its weights, batch and
    noise. deepseek-v2 without shared experts (the reference's EP drops
    their share at M > 1, Queue C item 3), at its default capacity."""
    d = tmp_path_factory.mktemp("ref_step")
    feed = {}
    for arch in REF_ARCHS:
        cfg = get_config(arch, smoke=True, vqt=True)
        feed.update({f"{arch}/{k}": v.numpy() for k, v in _batch(cfg).items()})
    np.savez(d / "in.npz", **feed)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", REF_STEP, str(d / "in.npz"), str(d / "out.npz"),
                           str(ROOT / "tests")], capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_2x2_step_matches_the_references_sharded_step(reference_step, arch):
    """The port's (2, 2) grid, its parameters placed, against the
    reference's jitted ``value_and_grad`` under ``param_shardings`` on its
    Auto (2, 2) mesh: the same weights and noise; the loss within 1e-5,
    every gradient leaf within 1e-4 of its max."""
    ref = reference_step
    cfg = get_config(arch, smoke=True, vqt=True)
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_shared=0))
    from repro_torch.models.transformer import init_params

    like = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    names = list(_flat(like))
    it = iter(torch.tensor(ref[f"{arch}/param/{k}"]) for k in names)
    from repro_torch.common.pytree import tree_unflatten

    params = params_from_numpy(tree_unflatten(like, list(it)), device="cpu")
    noise = [ref[f"{arch}/noise/{i}"] for i in range(cfg.n_layers)]
    batch = {k: torch.as_tensor(ref_v) for k, ref_v in _batch(cfg).items()}
    grid = _grid((2, 2), ("data", "model"))
    with use_mesh(grid):
        loss, _, grads = value_and_grad(lm_loss, place(params, grid), cfg, batch, None,
                                        vq_noise=noise)
        grads = unplace(reduce_replicas(grads))
    want = float(ref[f"{arch}/loss"])
    assert abs(float(loss) - want) <= LOSS_TOL * max(1.0, abs(want))
    _close(_flat(grads), {k: ref[f"{arch}/grad/{k}"] for k in names}, LEAF_TOL,
           f"{arch} vs the reference")
