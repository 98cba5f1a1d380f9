"""The port's training (``repro_torch.training``, ``models.transformer.
forward(train=True)``, ``launch.train``) against the JAX package's on the
smoke configs, with the reference's weights (``tests/_torch_parity``) and
its per-layer Gumbel noise, ``jax.random.gumbel(fold_in(rng, li*8 + pi),
...)``, handed to the port:

* the losses within 1e-6, AdamW and the schedule on identical inputs
  within 1e-6 (relative, and of each leaf's largest magnitude: the global
  norm's f32 sums differ in order);
* one train step and one distill step against the reference's jitted
  steps: the loss, its parts and the grad norm within 1e-5, every gradient
  leaf within 1e-5 of its largest magnitude (f32 sums in another order; the
  sampled-position table's scatter-add included), VQ codes equal or
  flipped only at a near tie (top two Gumbel logits within 1e-5, counted);
* ``accum_steps=4`` against 1 within the reference's 5e-3, and the port's
  own loss falling over a few steps.
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import params_to_numpy, smoke_params  # noqa: E402
from repro.checkpoint import restore_train_state as ref_restore_train_state  # noqa: E402
from repro.configs.vq_opt_125m import smoke_config as ref_smoke  # noqa: E402
from repro.data import SyntheticCorpus, lm_batches  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.training import losses as ref_losses  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro.training import step as ref_step  # noqa: E402
from repro_torch.checkpoint import restore_train_state  # noqa: E402
from repro_torch.common.pytree import path_names, tree_flatten_with_path  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.vq_opt_125m import smoke_config  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.training import (  # noqa: E402
    TrainState, adamw_init, adamw_update, distill_loss, make_distill_step, make_schedule,
    make_train_step, next_token_loss, train_state_init,
)
from repro_torch.training.losses import classification_loss  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig, global_norm  # noqa: E402
from repro_torch.training.step import lm_loss, value_and_grad  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIE = 1e-5
B, N = 2, 32


def _np_tree(tree) -> dict:
    """{path: numpy leaf} of a port tree (detached tensors) or a reference
    tree."""
    return {"/".join(path_names(p)): leaf
            for p, leaf in tree_flatten_with_path(params_to_numpy(tree))}


def ref_noise(cfg, rng, b, n) -> list:
    """The reference's Gumbel noise of each layer (by global index) under
    ``_run_stages``: ``fold_in(rng, li * 8 + pi)``, li the index of the
    pattern's first layer."""
    out, g = [], 0
    for pattern, repeat in cfg.stages:
        for _ in range(repeat):
            for pi, _layer in enumerate(pattern):
                key = jax.random.fold_in(rng, (g - pi) * 8 + pi)
                out.append(np.asarray(jax.random.gumbel(
                    key, (b, n, cfg.vqt.n_heads, cfg.vqt.codebook_size))))
                g += 1
    return out


def _batch(cfg, seed=0, b=B, n=N):
    return next(lm_batches(SyntheticCorpus(vocab=cfg.vocab, seed=seed), batch=b, seq_len=n,
                           steps=1, seed=seed, pos_pool=cfg.pos_pool))


def _grads_close(got: dict, want: dict, rel=1e-5):
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(got[k] - w).max())
        assert err <= rel * scale, f"{k}: {err} of max {scale}"


def _vq_calls(ref_params, batch, noise):
    """The port's training-mode VQ calls of a forward on these weights,
    batch and noise: (codes, where the top two Gumbel logits lie within
    TIE) of each layer."""
    calls = []
    from repro_torch.core import vq as port_vq

    real = port_vq.forward_train

    def spy(params, x, cfg, *, noise=None, generator=None):
        out = real(params, x, cfg, noise=noise, generator=generator)
        s = port_vq.scores(params, x.detach()) + noise
        top2 = torch.topk(s / cfg.temperature, 2, dim=-1).values
        calls.append((out[1], (top2[..., 0] - top2[..., 1]) < TIE))
        return out

    port_vq.forward_train = spy
    try:
        tp = PT.params_from_numpy(params_to_numpy(ref_params), device="cpu")
        with torch.no_grad():
            PT.forward(tp, smoke_config(), torch.tensor(batch["tokens"]),
                       torch.tensor(batch["positions"]), train=True,
                       vq_noise=[torch.tensor(x) for x in noise], remat=False)
    finally:
        port_vq.forward_train = real
    return calls


@pytest.fixture(scope="module")
def lm_setup():
    cfg_j, params, np_params = smoke_params()
    batch = _batch(cfg_j)
    state_rng = jax.random.PRNGKey(5)
    rng = jax.random.split(state_rng)[0]  # what the reference's step draws with
    return cfg_j, params, np_params, batch, state_rng, ref_noise(cfg_j, rng, B, N)


# ---------------------------------------------------------------- losses


def test_next_token_loss_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 9, 50)).astype(np.float32) * 3
    toks = rng.integers(0, 50, (3, 9))
    mask = (rng.random((3, 9)) < 0.7).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = ref_losses.next_token_loss(jnp.asarray(logits), jnp.asarray(toks),
                                          None if m is None else jnp.asarray(m))
        got = next_token_loss(torch.tensor(logits), torch.tensor(toks),
                              None if m is None else torch.tensor(m))
        np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=1e-6)
    audio = rng.standard_normal((2, 7, 4, 30)).astype(np.float32)
    atoks = rng.integers(0, 30, (2, 7, 4))
    np.testing.assert_allclose(
        float(next_token_loss(torch.tensor(audio), torch.tensor(atoks))),
        float(ref_losses.next_token_loss(jnp.asarray(audio), jnp.asarray(atoks))),
        atol=1e-6, rtol=1e-6)


def test_distill_and_classification_losses_match_reference():
    rng = np.random.default_rng(1)
    s, t = (rng.standard_normal((2, 11, 40)).astype(np.float32) * 2 for _ in range(2))
    toks = rng.integers(0, 40, (2, 11))
    loss_j, parts_j = ref_losses.distill_loss(jnp.asarray(s), jnp.asarray(t), jnp.asarray(toks))
    loss, parts = distill_loss(torch.tensor(s), torch.tensor(t), torch.tensor(toks))
    np.testing.assert_allclose(float(loss), float(loss_j), atol=1e-6, rtol=1e-6)
    for k in ("kl", "lm"):
        np.testing.assert_allclose(float(parts[k]), float(parts_j[k]), atol=1e-6, rtol=1e-6)
    cls = rng.standard_normal((6, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 6)
    want = ref_losses.classification_loss(jnp.asarray(cls), jnp.asarray(labels))
    got = classification_loss(torch.tensor(cls), torch.tensor(labels))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------- optimizer


@pytest.mark.parametrize("kind,warmup,final", [("cosine", 10, 1e-4), ("linear", 3, 0.0),
                                               ("cosine", 0, 5e-5)])
def test_schedule_matches_reference(kind, warmup, final):
    ref = ref_opt.make_schedule(peak_lr=1e-3, warmup_steps=warmup, total_steps=40,
                                final_lr=final, kind=kind)
    port = make_schedule(peak_lr=1e-3, warmup_steps=warmup, total_steps=40, final_lr=final,
                         kind=kind)
    for i in (0, 1, 5, 10, 23, 40, 55):
        np.testing.assert_allclose(float(port(i)), float(ref(jnp.asarray(i))), rtol=1e-6,
                                   atol=1e-12)
        assert float(port(torch.tensor(i, dtype=torch.int32))) == float(port(i))


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])  # clipping off, then on
def test_adamw_matches_reference_on_identical_gradients(grad_scale):
    """Three updates fed the same gradients: params, moments, step and the
    grad norm within 1e-6 relative; weight decay on every leaf."""
    rng = np.random.default_rng(2)

    def tree(f):  # a dict, a list of tuples: the parameters' layout
        return {"w": f((5, 7)), "b": f((7,)), "stages": [(f((3, 4)),), (f((2, 2, 2)),)]}

    p0 = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    grads = [tree(lambda s: (rng.standard_normal(s) * grad_scale).astype(np.float32))
             for _ in range(3)]
    cfg = AdamWConfig()
    pj = jax.tree.map(jnp.asarray, p0)
    sj = ref_opt.adamw_init(pj)
    pt = jax.tree.map(torch.tensor, p0)
    st = adamw_init(pt)
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1)
        pj, sj, mj = ref_opt.adamw_update(pj, jax.tree.map(jnp.asarray, g), sj, jnp.asarray(lr))
        pt, st, mt = adamw_update(pt, jax.tree.map(torch.tensor, g), st, lr, cfg)
        np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]), rtol=1e-6)
        assert int(st.step) == int(sj.step) == i + 1
        for got, want in ((pt, pj), (st.mu, sj.mu), (st.nu, sj.nu)):
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
                b = np.asarray(b)
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                           atol=1e-6 * float(np.abs(b).max()))


def test_global_norm_matches_reference():
    rng = np.random.default_rng(3)
    t = {"a": rng.standard_normal((4, 5)).astype(np.float32), "b": [rng.standard_normal(3)
                                                                    .astype(np.float32)]}
    np.testing.assert_allclose(float(global_norm(jax.tree.map(torch.tensor, t))),
                               float(ref_opt.global_norm(t)), rtol=1e-6)


# ---------------------------------------------------------------- steps


def test_train_step_gradients_match_reference(lm_setup):
    """The LM loss and every gradient leaf of one step (remat on, through
    the ``gated_attention`` Function and the Gumbel VQ) against
    ``jax.grad`` of the reference's ``_lm_loss_fn`` with its noise."""
    cfg_j, params, np_params, batch, state_rng, noise = lm_setup
    rng = jax.random.split(state_rng)[0]
    grad_fn = jax.jit(lambda p, b, r: jax.value_and_grad(
        functools.partial(ref_step._lm_loss_fn, cfg=cfg_j), has_aux=True)(p, batch=b, rng=r))
    (loss_j, m_j), g_j = grad_fn(params, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    calls = _vq_calls(params, batch, noise)
    tp = PT.params_from_numpy(np_params, device="cpu")
    bt = {k: torch.tensor(v) for k, v in batch.items()}
    loss, m, g = value_and_grad(lm_loss, tp, smoke_config(), bt, None,
                                vq_noise=[torch.tensor(x) for x in noise])
    # no near tie on these inputs, so the codes are the reference's where
    # the gradients below agree
    assert len(calls) == 2 and all(not bool(t.any()) for _, t in calls)
    np.testing.assert_allclose(float(loss), float(loss_j), atol=1e-5, rtol=0)
    for k in ("lm_loss", "aux_loss"):
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), atol=1e-5, rtol=0)
    _grads_close(_np_tree(g), _np_tree(g_j))


def test_train_step_matches_the_references_jitted_step(lm_setup):
    """One ``make_train_step`` call against the reference's jitted step
    (peak lr from step 0): the metrics within 1e-5, the rng advanced; the
    same call twice gives the same bits."""
    cfg_j, params, np_params, batch, state_rng, noise = lm_setup
    sched_j = ref_opt.make_schedule(peak_lr=1e-3, warmup_steps=0, total_steps=10)
    step_j = jax.jit(ref_step.make_train_step(cfg_j, sched_j))
    _, m_j = step_j(ref_step.TrainState(params=params, opt=ref_opt.adamw_init(params),
                                        rng=state_rng),
                    {k: jnp.asarray(v) for k, v in batch.items()})
    tp = PT.params_from_numpy(np_params, device="cpu")
    state = TrainState(params=tp, opt=adamw_init(tp), rng=torch.tensor([3, 0]))
    step = make_train_step(smoke_config(), make_schedule(peak_lr=1e-3, warmup_steps=0,
                                                         total_steps=10))
    vq_noise = [torch.tensor(x) for x in noise]
    new, m = step(state, batch, vq_noise=vq_noise)
    for k in ("lm_loss", "aux_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), atol=1e-5, rtol=1e-5, err_msg=k)
    assert new.rng.tolist() == [3, 1] and int(new.opt.step) == 1
    again, _ = step(state, batch, vq_noise=vq_noise)
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(new.params),
                                                 jax.tree.leaves(again.params)))
    assert not torch.equal(new.params["embed"]["tok"], tp["embed"]["tok"])


def test_distill_step_matches_reference():
    """One ``make_distill_step`` call against the reference's jitted step
    (teacher: the plain OPT smoke config from PRNGKey(0)): loss, kl, lm,
    aux and grad norm within 1e-5; and the gradient of the distillation
    objective in every student leaf within 1e-5 of its largest magnitude."""
    cfg_j, params, np_params = smoke_params()
    teacher_cfg_j = ref_smoke(vqt=False)
    teacher = jax.device_get(RT.init_params(jax.random.PRNGKey(0), teacher_cfg_j))
    batch = {k: v for k, v in _batch(cfg_j, seed=1).items()}
    state_rng = jax.random.PRNGKey(9)
    noise = ref_noise(cfg_j, jax.random.split(state_rng)[0], B, N)
    sched_j = ref_opt.make_schedule(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    step_j = jax.jit(ref_step.make_distill_step(cfg_j, teacher_cfg_j, sched_j))
    _, m_j = step_j(ref_step.TrainState(params=params, opt=ref_opt.adamw_init(params),
                                        rng=state_rng), teacher,
                    {k: jnp.asarray(v) for k, v in batch.items()})
    tp = PT.params_from_numpy(np_params, device="cpu")
    teacher_t = PT.params_from_numpy(params_to_numpy(teacher), device="cpu")
    step = make_distill_step(smoke_config(), smoke_config(vqt=False),
                             make_schedule(peak_lr=1e-3, warmup_steps=2, total_steps=10))
    vq_noise = [torch.tensor(x) for x in noise]
    new, m = step(TrainState(params=tp, opt=adamw_init(tp), rng=torch.tensor([0, 0])),
                  teacher_t, batch, vq_noise=vq_noise)
    for k in ("loss", "kl", "lm", "aux_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), atol=1e-5, rtol=1e-5, err_msg=k)

    # the objective's gradient, leaf by leaf
    rng = jax.random.split(state_rng)[0]
    tokens = jnp.asarray(batch["tokens"])

    def ref_obj(p):
        t_logits, _ = RT.forward(teacher, teacher_cfg_j, tokens)
        s_logits, aux = RT.forward(p, cfg_j, tokens, jnp.asarray(batch["positions"]),
                                   train=True, rng=rng)
        return ref_losses.distill_loss(s_logits, t_logits, tokens)[0] + aux["aux_loss"]

    g_j = jax.jit(jax.grad(ref_obj))(params)

    def port_obj(p, t_logits):
        s_logits, aux = PT.forward(p, smoke_config(), torch.tensor(batch["tokens"]),
                                   torch.tensor(batch["positions"]), train=True,
                                   vq_noise=vq_noise)
        return (distill_loss(s_logits, t_logits, torch.tensor(batch["tokens"]))[0]
                + aux["aux_loss"], {})

    with torch.no_grad():
        t_logits, _ = PT.forward(teacher_t, smoke_config(vqt=False),
                                 torch.tensor(batch["tokens"]))
    _, _, g = value_and_grad(port_obj, tp, t_logits)
    calls = _vq_calls(params, batch, noise)
    assert len(calls) == 2 and all(not bool(t.any()) for _, t in calls)  # no near tie
    _grads_close(_np_tree(g), _np_tree(g_j))


def test_grad_accumulation_matches_full_batch():
    """accum_steps=4 against 1 on the plain OPT smoke config: the same data
    and seed, so near-identical updates (the reference's bound, 5e-3)."""
    cfg = smoke_config(vqt=False)
    state = train_state_init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    sched = make_schedule(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    batch = {"tokens": torch.randint(0, cfg.vocab, (8, 32),
                                     generator=torch.Generator().manual_seed(1))}
    s1, m1 = make_train_step(cfg, sched, accum_steps=1)(state, batch)
    s4, m4 = make_train_step(cfg, sched, accum_steps=4)(state, batch)
    d = max(float((a - b).abs().max()) for a, b in zip(jax.tree.leaves(s1.params),
                                                        jax.tree.leaves(s4.params)))
    assert d < 5e-3, d
    assert int(s4.opt.step) == 1 and s4.rng.tolist() == s1.rng.tolist()


def test_accumulation_feeds_every_microbatch_the_same_noise():
    """With noise drawn (not given), each microbatch reseeds the step's
    generator: two equal microbatches give exactly the full batch's
    gradient of one of them."""
    cfg = smoke_config()
    state = train_state_init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    one = _batch(cfg, b=2, n=16)
    two = {k: np.concatenate([v, v]) for k, v in one.items()}
    sched = make_schedule(peak_lr=1e-3, warmup_steps=0, total_steps=10)
    s1, _ = make_train_step(cfg, sched)(state, one)
    s2, _ = make_train_step(cfg, sched, accum_steps=2)(state, two)
    d = max(float((a - b).abs().max()) for a, b in zip(jax.tree.leaves(s1.params),
                                                        jax.tree.leaves(s2.params)))
    assert d < 1e-6, d


def test_port_loss_falls():
    cfg = smoke_config(vqt=True)
    state = train_state_init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    step = make_train_step(cfg, make_schedule(peak_lr=5e-4, warmup_steps=5, total_steps=60))
    losses = []
    for batch in lm_batches(SyntheticCorpus(vocab=cfg.vocab, seed=0), batch=8, seq_len=48,
                            steps=24, pos_pool=cfg.pos_pool):
        state, m = step(state, batch)
        losses.append(float(m["lm_loss"]))
        assert np.isfinite([float(m["aux_loss"]), float(m["grad_norm"])]).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4]) - 0.05, losses[::4]


def test_train_state_rng_is_a_seed_and_counter():
    cfg = smoke_config()
    st = train_state_init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert st.rng.dtype == torch.int64 and st.rng.shape == (2,) and int(st.rng[1]) == 0
    step = make_train_step(cfg, make_schedule(peak_lr=1e-3, warmup_steps=0, total_steps=4))
    batch = _batch(cfg, b=2, n=16)
    s1, m1 = step(st, batch)
    s2, _ = step(s1, batch)
    assert s2.rng.tolist() == [int(st.rng[0]), 2]
    _, again = step(st, batch)  # the same pair: the same noise
    assert float(again["aux_loss"]) == float(m1["aux_loss"])
    other = TrainState(params=st.params, opt=st.opt, rng=torch.tensor([int(st.rng[0]), 7]))
    _, moved = step(other, batch)  # another counter: other noise, other codes
    assert float(moved["aux_loss"]) != float(m1["aux_loss"])


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "hymba-1.5b", "rwkv6-7b",
                                  "deepseek-v3-671b"])
def test_training_other_families_raises_naming_item_10b(arch):
    """The families that once raised here train: one ``make_train_step``
    with a finite loss, aux loss and grad norm, and parameters that moved
    (``tests/test_torch_family_training.py`` holds them to the
    reference)."""
    cfg = get_config(arch, smoke=True)
    state = train_state_init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    step = make_train_step(cfg, make_schedule(peak_lr=1e-3, warmup_steps=0, total_steps=4))
    new, m = step(state, _batch(cfg, b=2, n=16))
    assert np.isfinite([float(m[k]) for k in ("lm_loss", "aux_loss", "grad_norm")]).all()
    assert not torch.equal(new.params["embed"]["tok"], state.params["embed"]["tok"])


@pytest.mark.slow
def test_launch_train_smoke_subprocess(tmp_path):
    """``python -m repro_torch.launch.train --smoke --device cpu``: the
    reference's step lines, then a train-state file that restores into the
    port's state and into the reference's."""
    ckpt = str(tmp_path / "state.npz")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "vq-opt-125m", "--smoke",
         "--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "32", "--log-every", "1",
         "--warmup", "1", "--ckpt", ckpt],
        capture_output=True, text=True, env=env, timeout=300, check=True).stdout
    lines = out.splitlines()
    assert lines[0] == "arch=vq-opt-125m-smoke layers=2 d=256 vocab=512"
    assert sum(line.startswith("step ") and "loss=" in line and "gnorm=" in line
               for line in lines) == 3
    assert lines[-1] == f"saved checkpoint to {ckpt}"
    like = train_state_init(smoke_config(), generator=torch.Generator().manual_seed(1),
                            device="cpu")
    st = restore_train_state(ckpt, like)
    assert int(st.opt.step) == 3 and int(st.rng[1]) == 3
    ref_like = ref_step.train_state_init(jax.random.PRNGKey(0), ref_smoke())
    ref_st = ref_restore_train_state(ckpt, ref_like)
    np.testing.assert_array_equal(np.asarray(ref_st.params["embed"]["tok"]),
                                  st.params["embed"]["tok"].numpy())
    assert int(ref_st.opt.step) == 3
