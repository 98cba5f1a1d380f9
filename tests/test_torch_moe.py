"""``repro_torch.models.moe`` against ``repro.models.moe``: the router's
gates, experts and aux loss; the routed dispatch (each expert on its own
tokens) against the reference's dense loop (every expert on every token)
at smoke size and at 8 experts top-2, with and without a shared expert;
and ``moe_per_code`` against the dense MoE on the decompressed tensor (the
port of ``tests/test_incr_patch_kernel.py:141``).

The port takes its top k with ``torch.topk``, the reference with
``jax.lax.top_k``. A token whose k-th and (k+1)-th router probabilities lie
within 1e-5 may pick another expert in either; such tokens are counted and
left out of the output comparison (every other token must match), and a
pick that differs away from a near tie fails."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import params_to_numpy  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import compressed as PC  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.transformer import params_from_numpy  # noqa: E402

ROUTE_TIE = 1e-5


def _cfgs(n_experts=None, top_k=None, n_shared=None):
    cfg, cfg_j = (get_config("deepseek-v2-236b", smoke=True),
                  ref_get_config("deepseek-v2-236b", smoke=True))
    kw = {k: v for k, v in dict(n_experts=n_experts, top_k=top_k, n_shared=n_shared).items()
          if v is not None}
    if kw:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))
        cfg_j = dataclasses.replace(cfg_j, moe=dataclasses.replace(cfg_j.moe, **kw))
    return cfg, cfg_j


def _params(cfg_j, seed=0):
    pj = ref_moe.moe_init(jax.random.PRNGKey(seed), cfg_j)
    return pj, params_from_numpy(params_to_numpy(pj), device="cpu")


def _x(seed, cfg, b, n, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((b, n, cfg.d_model)) * scale
            ).astype(np.float32)


def near_tie_tokens(params: dict, e, x: np.ndarray) -> np.ndarray:
    """[T] bool: the k-th and (k+1)-th router probabilities within ROUTE_TIE."""
    logits = x.reshape(-1, x.shape[-1]) @ params["router"].numpy()
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    top = -np.sort(-p, axis=-1)
    if e.top_k >= top.shape[-1]:
        return np.zeros(top.shape[0], bool)
    return (top[:, e.top_k - 1] - top[:, e.top_k]) <= ROUTE_TIE


def _routing(cfg, pt, pj, xt: np.ndarray):
    """(gates, experts) of both routers, the tokens whose picks differ (each
    must be a near tie) and the count of near ties."""
    gt, et, aux_t = moe._router(pt, cfg.moe, torch.tensor(xt))
    gj, ej, aux_j = ref_moe._router(pj, cfg.moe, jnp.asarray(xt))
    order_t, order_j = np.argsort(et.numpy(), -1), np.argsort(np.asarray(ej), -1)
    et_s = np.take_along_axis(et.numpy(), order_t, -1)
    ej_s = np.take_along_axis(np.asarray(ej), order_j, -1)
    differ = (et_s != ej_s).any(-1)
    near = near_tie_tokens(pt, cfg.moe, xt)
    assert not (differ & ~near).any(), "router picks differ away from a near tie"
    gates = (np.take_along_axis(gt.numpy(), order_t, -1), np.take_along_axis(
        np.asarray(gj), order_j, -1))
    return gates, differ, int(near.sum()), (float(aux_t), float(aux_j))


@pytest.mark.parametrize("seed", range(3))
def test_router_matches_reference(seed):
    cfg, cfg_j = _cfgs()
    pj, pt = _params(cfg_j, seed)
    xt = _x(seed, cfg, 1, 64)[0]
    (g_t, g_j), differ, n_near, (aux_t, aux_j) = _routing(cfg, pt, pj, xt)
    np.testing.assert_allclose(g_t[~differ], g_j[~differ], atol=1e-6, rtol=0)
    np.testing.assert_allclose(g_t.sum(-1), 1.0, atol=1e-6)
    np.testing.assert_allclose(aux_t, aux_j, rtol=1e-5)
    print(f"seed {seed}: {n_near} near-tie tokens, {int(differ.sum())} flipped")


def _dense_case(cfg, cfg_j, seed, b=2, n=24):
    pj, pt = _params(cfg_j, seed)
    x = _x(seed + 7, cfg, b, n)
    y_t, aux_t = moe.moe_apply_dense(pt, cfg, torch.tensor(x))
    y_j, aux_j = ref_moe.moe_apply_dense(pj, cfg_j, jnp.asarray(x))
    _, differ, n_near, _ = _routing(cfg, pt, pj, x.reshape(-1, cfg.d_model))
    keep = ~differ.reshape(b, n)
    np.testing.assert_allclose(y_t.numpy()[keep], np.asarray(y_j)[keep], atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
    return int(differ.sum()), n_near


@pytest.mark.parametrize("seed", range(2))
def test_dense_dispatch_matches_reference_at_smoke_size(seed):
    """4 experts top-2 and one shared expert (the smoke config)."""
    cfg, cfg_j = _cfgs()
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.n_shared) == (4, 2, 1)
    flipped, near = _dense_case(cfg, cfg_j, seed)
    print(f"smoke seed {seed}: {near} near-tie tokens, {flipped} flipped")


@pytest.mark.parametrize("n_shared", [0, 1])
def test_dense_dispatch_matches_reference_at_8_experts_top_2(n_shared):
    """8 experts top-2: some experts get no token at 2 x 5 tokens, which the
    dispatch skips."""
    cfg, cfg_j = _cfgs(n_experts=8, top_k=2, n_shared=n_shared)
    for n in (5, 24):
        _dense_case(cfg, cfg_j, n_shared, n=n)
    pj, pt = _params(cfg_j, n_shared)
    assert ("shared" in pt) == bool(n_shared)


def test_apply_is_the_dense_path_and_counts_one_host_read(monkeypatch):
    """``moe_apply`` (no mesh) is ``moe_apply_dense``; the dispatch reads
    the per-expert counts from the device once a call."""
    cfg, cfg_j = _cfgs(n_experts=8, top_k=2)
    _, pt = _params(cfg_j)
    x = torch.tensor(_x(3, cfg, 2, 6))
    reads = []
    tolist = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist", lambda t: (reads.append(t.shape), tolist(t))[1])
    y1, a1 = moe.moe_apply(pt, cfg, x)
    assert reads == [(8,)]
    monkeypatch.undo()
    y2, a2 = moe.moe_apply_dense(pt, cfg, x)
    assert torch.equal(y1, y2) and torch.equal(a1, a2)


def test_near_tie_tokens_are_counted_not_skipped():
    """Two router columns made equal: every token ties between experts 0
    and 1 at the k-th place, and the helper counts each of them."""
    cfg, cfg_j = _cfgs(n_experts=4, top_k=1, n_shared=0)
    pj, pt = _params(cfg_j)
    pt = dict(pt, router=pt["router"].clone())
    pt["router"][:, 1] = pt["router"][:, 0]
    pt["router"][:, 2:] = -pt["router"][:, :1].abs() - 1.0  # 0 and 1 lead
    x = np.abs(_x(4, cfg, 1, 8))[0]
    assert near_tie_tokens(pt, cfg.moe, x).sum() == 8


def test_moe_per_code_equals_dense():
    """Routing and the experts once per codebook row (6 rows) equal the
    dense MoE over the 3 x 10 decompressed tokens within 2e-5, and the
    result keeps the 6 rows and the index map."""
    cfg, cfg_j = _cfgs()
    pj, pt = _params(cfg_j)
    rng = np.random.default_rng(2)
    rows = rng.standard_normal((6, cfg.d_model)).astype(np.float32)
    idx = rng.integers(0, 6, (3, 10)).astype(np.int32)
    c = PC.from_dense_rows(torch.tensor(rows), torch.tensor(idx))
    y_c, aux_c = moe.moe_per_code(pt, cfg, c)
    y_d, _ = moe.moe_apply_dense(pt, cfg, c.to_dense())
    np.testing.assert_allclose(y_c.to_dense().numpy(), y_d.numpy(), atol=2e-5, rtol=2e-5)
    assert y_c.codebook.shape[0] == 6 and torch.equal(y_c.idx, c.idx)
    from repro.core import compressed as RC

    y_j, aux_j = ref_moe.moe_per_code(pj, cfg_j, RC.from_dense_rows(jnp.asarray(rows),
                                                                     jnp.asarray(idx)))
    _, differ, _, _ = _routing(cfg, pt, pj, rows)
    np.testing.assert_allclose(y_c.codebook.numpy()[~differ],
                               np.asarray(y_j.codebook)[~differ], atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(float(aux_c), float(aux_j), rtol=1e-5)
