"""The MLA / MoE model families (deepseek-v2-236b, deepseek-v3-671b) in the
port against ``repro.models.transformer`` on the reference's own
smoke-config weights (PRNGKey(1)), both variants: configs equal field by
field at full and smoke size (``moe``, ``mla`` and ``mtp`` included), the
weights carried across bit for bit, forward logits within 3e-4 with equal
VQ codes, ``aux_loss`` (the router's load-balance loss) within rtol 1e-5,
v3's ``mtp_logits`` within 3e-4, decode steps (logits and every latent
cache leaf) within 3e-4 of the reference's ``decode_step``, the port's
decode within 2e-3 of its own forward (``tests/test_models.py:85-89``), and
``prefill_step`` refusing MLA stacks, as the reference's does.

The port's MoE routes with ``torch.topk``; where a token's k-th and
(k+1)-th router probabilities lie within 1e-5 the two packages may pick
different experts. Every routing of both forwards is recorded: a token
whose experts differ must sit at such a near tie, and is counted and
reported (its logits are then exempt); one that differs away from a near
tie fails the test."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import arch_params  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import vq as ref_vq  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import vq as port_vq  # noqa: E402
from repro_torch.models import moe as port_moe  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

ARCHS = ("deepseek-v2-236b", "deepseek-v3-671b")
CASES = [(a, v) for a in ARCHS for v in (False, True)]
ATOL = 3e-4
ROUTE_TIE = 1e-5  # k-th and (k+1)-th router probabilities this close may swap


@functools.lru_cache(maxsize=None)
def _setup(arch, vqt):
    """(port cfg, reference cfg, reference params, port params)."""
    cfg = get_config(arch, smoke=True, vqt=vqt)
    cfg_j, params, np_params = arch_params(arch, vqt)
    return cfg, cfg_j, params, PT.params_from_numpy(np_params, device="cpu")


def _inputs(cfg, seed, b=2, n=24):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, n)).astype(np.int32)
    return toks, np.arange(n)[None].repeat(b, 0).astype(np.int32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif hasattr(tree, "codebook") and not hasattr(tree, "shape"):  # VQParams
        yield path + ("codebook",), tree.codebook
    else:
        yield path, tree


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0)


def _recording(monkeypatch, mod):
    codes = []
    quantize = mod.quantize

    def rec(p, x):
        x_q, idx = quantize(p, x)
        codes.append(np.asarray(idx))
        return x_q, idx

    monkeypatch.setattr(mod, "quantize", rec)
    return codes


def _routes(monkeypatch, mod):
    """Record every ``_router`` call of ``mod``: (sorted expert ids [T, k],
    the gap between the k-th and (k+1)-th probabilities [T])."""
    calls = []
    router = mod._router

    def rec(params, e, x):
        gates, eidx, aux = router(params, e, x)
        logits = np.asarray(x, np.float32) @ np.asarray(params["router"], np.float32)
        p = np.exp(logits - logits.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        top = -np.sort(-p, axis=-1)
        calls.append((np.sort(np.asarray(eidx), -1), top[:, e.top_k - 1] - top[:, e.top_k]))
        return gates, eidx, aux

    monkeypatch.setattr(mod, "_router", rec)
    return calls


def route_flips(ref_calls, port_calls, shape) -> np.ndarray:
    """Tokens ([b, n] bool) whose experts differ between the two packages'
    routings in any MoE layer; each must be a near tie (k-th and (k+1)-th
    probabilities within ROUTE_TIE in either package), else the test fails."""
    assert len(ref_calls) == len(port_calls)
    flipped = np.zeros(shape, bool)
    for (ej, gj), (et, gt) in zip(ref_calls, port_calls):
        diff = (ej != et).any(-1)
        near = (gj <= ROUTE_TIE) | (gt <= ROUTE_TIE)
        assert not (diff & ~near).any(), "router picks differ away from a near tie"
        flipped |= diff.reshape(shape)
    return flipped


@pytest.mark.parametrize("arch,vqt", CASES)
def test_config_fields_match_reference(arch, vqt):
    for smoke in (False, True):
        ours = get_config(arch, smoke=smoke, vqt=vqt)
        ref = ref_get_config(arch, smoke=smoke, vqt=vqt)
        for f in dataclasses.fields(ref):
            a, b = getattr(ours, f.name), getattr(ref, f.name)
            if f.name in ("vqt", "moe", "mla", "ssm", "rwkv") and b is not None:
                a, b = _fields(a), _fields(b)
            if f.name == "stages":
                a, b = ([(tuple(map(_fields, pat)), r) for pat, r in st] for st in (a, b))
            assert a == b, (arch, smoke, f.name, a, b)
        assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(ref)]
    full = get_config(arch)
    assert full.mla.kv_lora == 512 and full.mtp == (arch == "deepseek-v3-671b")
    assert get_config(arch, smoke=True).moe.n_experts == 4


@pytest.mark.parametrize("arch,vqt", CASES)
def test_params_carry_across_bitwise(arch, vqt):
    """The reference's init turns into the port's tree with the same keys,
    shapes and bits; the port's own init has the reference's layout."""
    cfg, _, params, tp = _setup(arch, vqt)
    ref = list(_leaves(params))
    ported = list(_leaves(tp))
    assert [p for p, _ in ref] == [p for p, _ in ported]
    for (path, a), (_, t) in zip(ref, ported):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a), err_msg=str(path))
    own = list(_leaves(PT.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                      device="cpu")))
    assert [(p, tuple(t.shape)) for p, t in own] == [(p, tuple(a.shape)) for p, a in ref]
    assert any("vq" in p for p, _ in own) == vqt
    assert any("mtp" in p for p, _ in own) == cfg.mtp


@pytest.mark.parametrize("arch,vqt", CASES)
def test_forward_matches_reference(monkeypatch, arch, vqt):
    """Logits, hidden states and (v3) ``mtp_logits`` within 3e-4, equal VQ
    codes, ``aux_loss`` within rtol 1e-5; routing near ties counted."""
    cfg, cfg_j, params, tp = _setup(arch, vqt)
    toks, pos = _inputs(cfg, 0, n=40)
    codes_j = _recording(monkeypatch, ref_vq)
    codes_t = _recording(monkeypatch, port_vq)
    routes_j = _routes(monkeypatch, ref_moe)
    routes_t = _routes(monkeypatch, port_moe)
    want, aux_j = RT.forward(params, cfg_j, jnp.asarray(toks), jnp.asarray(pos))
    got, aux = PT.forward(tp, cfg, torch.tensor(toks), torch.tensor(pos))
    assert got.shape == want.shape == (2, 40, cfg.vocab)
    flipped = route_flips(routes_j, routes_t, toks.shape)
    assert len(routes_t) == sum(layer.ffn == "moe" for layer in cfg.layer_list())
    keep = ~flipped
    _close(got.numpy()[keep], np.asarray(want)[keep])
    _close(aux["hidden"].numpy()[keep], np.asarray(aux_j["hidden"])[keep])
    np.testing.assert_allclose(float(aux["aux_loss"]), float(aux_j["aux_loss"]), rtol=1e-5)
    assert float(aux["aux_loss"]) > 0
    assert ("mtp_logits" in aux) == cfg.mtp == ("mtp_logits" in aux_j)
    if cfg.mtp:
        assert aux["mtp_logits"].shape == (2, 40, cfg.vocab)
        _close(aux["mtp_logits"].numpy()[keep], np.asarray(aux_j["mtp_logits"])[keep])
    assert len(codes_t) == (cfg.n_layers if vqt else 0) == len(codes_j)
    for a, b in zip(codes_t, codes_j):
        np.testing.assert_array_equal(a[keep], b[keep])
    print(f"{arch} vqt={vqt}: {int(flipped.sum())} tokens at a routing near tie")


@functools.lru_cache(maxsize=None)
def _ref_step(arch, vqt):
    cfg_j = _setup(arch, vqt)[1]
    return jax.jit(lambda p, c, t, pos: RT.decode_step(p, cfg_j, t, c, pos))


@pytest.mark.parametrize("arch,vqt", CASES)
def test_decode_matches_reference(monkeypatch, arch, vqt):
    """``decode_step`` from ``init_caches`` against the reference's, step by
    step: logits, and every latent cache leaf at the end. The jitted
    reference's routing is not observable, so the port's own top-k gaps
    must all be clear of ROUTE_TIE for the comparison to hold."""
    cfg, cfg_j, params, tp = _setup(arch, vqt)
    n = 6
    toks, pos = _inputs(cfg, 1, n=n)
    cj = RT.init_caches(cfg_j, 2, n, dtype=jnp.float32)
    ct = PT.init_caches(cfg, 2, n, device="cpu")
    assert [p for p, _ in _leaves(cj)] == [p for p, _ in _leaves(ct)]
    assert ct[0][0]["mix"]["ckv"].shape == (1, 2, n, cfg.mla.kv_lora)
    assert ct[0][0]["mix"]["ckv"].dtype == torch.float32
    routes_t = _routes(monkeypatch, port_moe)
    step = _ref_step(arch, vqt)
    for i in range(n):
        lj, cj = step(params, cj, jnp.asarray(toks[:, i:i + 1]), jnp.asarray(pos[:, i:i + 1]))
        lt, ct = PT.decode_step(tp, cfg, torch.tensor(toks[:, i:i + 1]), ct,
                                torch.tensor(pos[:, i:i + 1]))
        assert lt.shape == lj.shape
        _close(lt.numpy(), lj)
    assert min(float(g.min()) for _, g in routes_t) > ROUTE_TIE
    for (path, a), (_, t) in zip(_leaves(cj), _leaves(ct)):
        assert tuple(t.shape) == a.shape, path
        _close(t.numpy(), a)
    assert int(ct[0][0]["mix"]["len"][0, 0]) == n


@pytest.mark.parametrize("arch,vqt", CASES)
def test_decode_matches_own_forward(arch, vqt):
    """n tokens through ``decode_step`` give the forward's last logits within
    2e-3."""
    cfg, _, _, tp = _setup(arch, vqt)
    n = 24
    toks, pos = _inputs(cfg, 2, n=n)
    full, _ = PT.forward(tp, cfg, torch.tensor(toks), torch.tensor(pos))
    caches = PT.init_caches(cfg, 2, n, device="cpu")
    for i in range(n):
        step, caches = PT.decode_step(tp, cfg, torch.tensor(toks[:, i:i + 1]), caches,
                                      torch.tensor(pos[:, i:i + 1]))
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(), atol=2e-3, rtol=2e-3)


def test_mla_families_refuse_prefill_and_kv_export():
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        assert not PT.chunkable(cfg) and not RT.chunkable(ref_get_config(arch, smoke=True))
        with pytest.raises(ValueError, match="chunked prefill"):
            PT.prefill_step({}, cfg, torch.zeros((1, 2), dtype=torch.int64), [], None)
        k = torch.zeros((2, 1, 4, cfg.n_kv_heads, cfg.resolved_head_dim))
        with pytest.raises(ValueError, match="non-windowed gqa"):
            PT.caches_from_kv(cfg, k, k, [4])


def test_training_still_raises_naming_item_10():
    cfg, _, _, tp = _setup("deepseek-v2-236b", True)
    with pytest.raises(NotImplementedError, match="item 10"):
        PT.forward(tp, cfg, torch.zeros((1, 4), dtype=torch.int64), train=True)
