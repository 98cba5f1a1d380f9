"""The recurrent model families (hymba-1.5b, rwkv6-7b) in the port against
``repro.models.transformer`` on the reference's own smoke-config weights
(PRNGKey(1)), both variants (rwkv6's ``vqt=True`` stays vanilla, as in the
reference): configs equal at full and smoke size, the weights carried
across bit for bit, forward logits within 3e-4 with equal VQ codes, decode
steps (logits and every cache leaf: KV rings, SSM, conv and RWKV states)
within 3e-4 of the reference's, and the port's decode within 2e-3 of its
own forward (``tests/test_models.py:85-89``). The smoke hymba keeps the
first and last layers, both global, so a variant with a windowed second
layer is decoded past its window too; and the mixers' pieces (time-mix
with a carried state, channel-mix, the causal conv) are held one by one."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import arch_params  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import LayerCfg as RefLayerCfg  # noqa: E402
from repro.core import vq as ref_vq  # noqa: E402
from repro.models import hymba as ref_hymba  # noqa: E402
from repro.models import rwkv6 as ref_rwkv  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import LayerCfg  # noqa: E402
from repro_torch.core import vq as port_vq  # noqa: E402
from repro_torch.models import hymba as port_hymba  # noqa: E402
from repro_torch.models import rwkv6 as port_rwkv  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

CASES = [("hymba-1.5b", False), ("hymba-1.5b", True), ("rwkv6-7b", False)]
ATOL = 3e-4
WINDOW = 16  # the windowed hymba variant's ring


def _windowed(cfg, layer_cls):
    """hymba's smoke config with its second layer windowed (``layer_cls``:
    either package's ``LayerCfg``)."""
    return dataclasses.replace(cfg, name=cfg.name + "-windowed", stages=(
        ((layer_cls("hymba", "swiglu"),), 1), ((layer_cls("hymba", "swiglu", window=WINDOW),), 1)))


@functools.lru_cache(maxsize=None)
def _setup(arch, vqt, windowed=False):
    """(port cfg, reference cfg, reference params, port params)."""
    cfg = get_config(arch, smoke=True, vqt=vqt)
    ref_cfg = None
    if windowed:
        cfg = _windowed(cfg, LayerCfg)
        ref_cfg = _windowed(ref_get_config(arch, smoke=True, vqt=vqt), RefLayerCfg)
    cfg_j, params, np_params = arch_params(arch, vqt, cfg=ref_cfg)
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


@pytest.mark.parametrize("arch,vqt", [(a, v) for a in ("hymba-1.5b", "rwkv6-7b")
                                      for v in (False, True)])
def test_config_fields_match_reference(arch, vqt):
    for smoke in (False, True):
        ours = get_config(arch, smoke=smoke, vqt=vqt)
        ref = ref_get_config(arch, smoke=smoke, vqt=vqt)
        for f in dataclasses.fields(ours):
            a, b = getattr(ours, f.name), getattr(ref, f.name)
            if f.name in ("vqt", "ssm", "rwkv") and a is not None:
                a, b = _fields(a), _fields(b)
            if f.name == "stages":
                a, b = ([(tuple(map(_fields, pat)), r) for pat, r in st] for st in (a, b))
            assert a == b, (arch, smoke, f.name, a, b)
        assert (ref.moe, ref.mla, ref.mtp) == (None, None, False)
    assert get_config("rwkv6-7b", vqt=True) == get_config("rwkv6-7b")  # VQT inapplicable
    full = get_config("hymba-1.5b", vqt=True)
    assert [layer.window for layer in full.layer_list()].count(None) == 3
    assert full.resolved_head_dim == 64 and full.ssm.d_state == 16
    assert get_config("rwkv6-7b").rwkv.head_dim == 64


def test_later_families_still_raise():
    """The MLA / MoE families resolve to the reference's values now; what
    is left of a later slice, training, raises naming its ROADMAP item."""
    for name in ("deepseek-v2-236b", "deepseek-v3-671b"):
        for smoke in (False, True):
            assert get_config(name, smoke=smoke) == _ported_copy(
                ref_get_config(name, smoke=smoke))
    cfg = get_config("deepseek-v2-236b", smoke=True)
    params = PT.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        PT.forward(params, cfg, torch.zeros((1, 4), dtype=torch.int64), train=True)


def _ported_copy(ref_cfg):
    """The port's ``ArchConfig`` with the reference config's values."""
    from repro_torch.configs import base
    from repro_torch.core.vq import VQConfig

    subs = dict(moe=base.MoECfg, mla=base.MLACfg, ssm=base.SSMCfg, rwkv=base.RWKVCfg,
                vqt=VQConfig)
    kw = {f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(ref_cfg)}
    for key, cls in subs.items():
        if kw[key] is not None:
            kw[key] = cls(**_fields(kw[key]))
    kw["stages"] = tuple((tuple(base.LayerCfg(**_fields(layer)) for layer in pat), r)
                         for pat, r in kw["stages"])
    return base.ArchConfig(**kw)


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


@pytest.mark.parametrize("arch,vqt,windowed", [c + (False,) for c in CASES]
                         + [("hymba-1.5b", True, True)])
def test_forward_matches_reference(monkeypatch, arch, vqt, windowed):
    """n = 40 is not a multiple of the scan's chunk (zero-padded) and runs
    past the windowed variant's ring."""
    cfg, cfg_j, params, tp = _setup(arch, vqt, windowed)
    toks, pos = _inputs(cfg, 0, n=40)
    codes_j = _recording(monkeypatch, ref_vq)
    codes_t = _recording(monkeypatch, port_vq)
    want, aux_j = RT.forward(params, cfg_j, jnp.asarray(toks), jnp.asarray(pos))
    got, aux = PT.forward(tp, cfg, torch.tensor(toks), torch.tensor(pos))
    assert got.shape == want.shape == (2, 40, cfg.vocab)
    _close(got.numpy(), want)
    _close(aux["hidden"].numpy(), aux_j["hidden"])
    assert len(codes_t) == (cfg.n_layers if vqt else 0) == len(codes_j)
    for a, b in zip(codes_t, codes_j):
        np.testing.assert_array_equal(a, b)


@functools.lru_cache(maxsize=None)
def _ref_step(arch, vqt, windowed=False):
    cfg_j = _setup(arch, vqt, windowed)[1]
    return jax.jit(lambda p, c, t, pos: RT.decode_step(p, cfg_j, t, c, pos))


def _cache_leaves(caches):
    return [(p, t) for p, t in _leaves(caches)]


@pytest.mark.parametrize("arch,vqt,windowed,n", [c + (False, 5) for c in CASES]
                         + [("hymba-1.5b", True, True, WINDOW + 8)])
def test_decode_matches_reference(arch, vqt, windowed, n):
    """``decode_step`` from ``init_caches`` against the reference's, step by
    step: logits, and every cache leaf at the end (the windowed variant's
    ring has wrapped)."""
    cfg, cfg_j, params, tp = _setup(arch, vqt, windowed)
    toks, pos = _inputs(cfg, 1, n=n)
    cj = RT.init_caches(cfg_j, 2, n, dtype=jnp.float32)
    ct = PT.init_caches(cfg, 2, n, device="cpu")
    assert [p for p, _ in _cache_leaves(cj)] == [p for p, _ in _cache_leaves(ct)]
    step = _ref_step(arch, vqt, windowed)
    for i in range(n):
        lj, cj = step(params, cj, jnp.asarray(toks[:, i:i + 1]), jnp.asarray(pos[:, i:i + 1]))
        lt, ct = PT.decode_step(tp, cfg, torch.tensor(toks[:, i:i + 1]), ct,
                                torch.tensor(pos[:, i:i + 1]))
        assert lt.shape == lj.shape
        _close(lt.numpy(), lj)
    for (path, a), (_, t) in zip(_cache_leaves(cj), _cache_leaves(ct)):
        assert tuple(t.shape) == a.shape, path
        _close(t.numpy(), a)
    if windowed:
        ring = ct[1][0]["mix"]["attn"]
        assert ring["k"].shape[2] == WINDOW and int(ring["len"][0, 0]) == n


@pytest.mark.parametrize("arch,vqt,windowed,n", [c + (False, 24) for c in CASES]
                         + [("hymba-1.5b", v, True, 40) for v in (False, True)])
def test_decode_matches_own_forward(arch, vqt, windowed, n):
    """n tokens through ``decode_step`` give the forward's last logits within
    2e-3 (the windowed variant past its 16-slot ring)."""
    cfg, _, _, tp = _setup(arch, vqt, windowed)
    toks, pos = _inputs(cfg, 2, n=n)
    full, _ = PT.forward(tp, cfg, torch.tensor(toks), torch.tensor(pos))
    caches = PT.init_caches(cfg, 2, n, device="cpu")
    for i in range(n):
        step, caches = PT.decode_step(tp, cfg, torch.tensor(toks[:, i:i + 1]), caches,
                                      torch.tensor(pos[:, i:i + 1]))
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(), atol=2e-3, rtol=2e-3)


def test_recurrent_families_refuse_prefill_and_kv_export():
    for arch in ("hymba-1.5b", "rwkv6-7b"):
        cfg = get_config(arch, smoke=True)
        assert not PT.chunkable(cfg) and not RT.chunkable(ref_get_config(arch, smoke=True))
        with pytest.raises(ValueError, match="chunked prefill"):
            PT.prefill_step({}, cfg, torch.zeros((1, 2), dtype=torch.int64), [], None)
        k = torch.zeros((2, 1, 4, cfg.n_kv_heads, cfg.resolved_head_dim))
        with pytest.raises(ValueError, match="non-windowed gqa"):
            PT.caches_from_kv(cfg, k, k, [4])


def test_greedy_decode_matches_reference():
    """``serving/decode.greedy_decode`` carries the recurrent caches (token
    by token, as neither family is chunkable): hymba with VQT gives the
    reference's tokens."""
    from repro.serving.decode import greedy_decode as ref_greedy_decode
    from repro_torch.serving.decode import greedy_decode

    cfg, cfg_j, params, tp = _setup("hymba-1.5b", True)
    toks, pos = _inputs(cfg, 4, n=6)
    want, _ = ref_greedy_decode(params, cfg_j, jnp.asarray(toks), 4, positions=jnp.asarray(pos))
    got, _ = greedy_decode(tp, cfg, torch.tensor(toks), 4, positions=torch.tensor(pos))
    assert got.shape == want.shape == (2, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _layer(arch, vqt=False):
    """(port cfg, reference cfg, layer 0's reference params, its port params)."""
    cfg, cfg_j, params, tp = _setup(arch, vqt)
    first = lambda tree: jax.tree.map(lambda a: a[0], tree[0])  # noqa: E731
    return cfg, cfg_j, first(params["stages"][0]), PT._index(tp["stages"][0], 0)[0]


def _x(seed, cfg, n, b=2):
    return np.random.default_rng(seed).standard_normal((b, n, cfg.d_model)).astype(np.float32)


def test_rwkv_time_and_channel_mix_carry_their_states():
    """The time-mix over n = 21 (padded to 32) from a carried state and token
    shift: output, final WKV state and x_final against the reference's;
    then the channel-mix with its carried token."""
    cfg, cfg_j, lj, lt = _layer("rwkv6-7b")
    x, x_last = _x(6, cfg, 21), _x(7, cfg, 1)[:, 0]
    s0 = (np.random.default_rng(8).standard_normal((2, cfg.d_model // 32, 32, 32)) * 0.1
          ).astype(np.float32)
    out_j, s_j, xf_j = ref_rwkv.rwkv_time_mix(lj["mixer"], cfg_j, jnp.asarray(x),
                                              jnp.asarray(x_last), jnp.asarray(s0))
    out_t, s_t, xf_t = port_rwkv.rwkv_time_mix(lt["mixer"], cfg, torch.tensor(x),
                                               torch.tensor(x_last), torch.tensor(s0))
    _close(out_t.numpy(), out_j, atol=1e-5)
    _close(s_t.numpy(), s_j, atol=1e-5)
    np.testing.assert_array_equal(xf_t.numpy(), np.asarray(xf_j))
    cm_j, last_j = ref_rwkv.rwkv_channel_mix(lj["ffn"], jnp.asarray(x), jnp.asarray(x_last))
    cm_t, last_t = port_rwkv.rwkv_channel_mix(lt["ffn"], torch.tensor(x), torch.tensor(x_last))
    _close(cm_t.numpy(), cm_j, atol=1e-5)
    np.testing.assert_array_equal(last_t.numpy(), np.asarray(last_j))


def test_hymba_causal_conv_and_ssm_operands_match_reference():
    """The depthwise conv from a carried state (its new state the last
    d_conv - 1 inputs) and the SSD operands built from it."""
    cfg, cfg_j, lj, lt = _layer("hymba-1.5b")
    d_inner = cfg.n_heads * cfg.resolved_head_dim
    xs = np.random.default_rng(9).standard_normal((2, 7, d_inner)).astype(np.float32)
    state = np.random.default_rng(10).standard_normal((2, 3, d_inner)).astype(np.float32)
    xc_j, st_j = ref_hymba._causal_conv(lj["mixer"], jnp.asarray(xs), jnp.asarray(state))
    xc_t, st_t = port_hymba._causal_conv(lt["mixer"], torch.tensor(xs), torch.tensor(state))
    _close(xc_t.numpy(), xc_j, atol=1e-5)
    np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))
    np.testing.assert_array_equal(st_t.numpy(), xs[:, -3:])
    x = _x(11, cfg, 7)
    for a, b in zip(port_hymba._ssm_qkv(lt["mixer"], cfg, xc_t, torch.tensor(x)),
                    ref_hymba._ssm_qkv(lj["mixer"], cfg_j, xc_j, jnp.asarray(x))):
        assert tuple(a.shape) == b.shape
        _close(a.numpy(), b, atol=1e-5)
