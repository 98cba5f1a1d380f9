"""The port's model forward and decode path (``models/*``,
``serving/decode``) against ``repro.models.transformer`` on the smoke
config's weights and seeded numpy tokens with gapped (sampled) positions:
logits within 3e-4, greedy tokens equal, caches within 3e-4. Also the
layers underneath (norm, FFN, embedding) and the KV export bridge."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import smoke_params  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.embedding import embed_tokens as ref_embed  # noqa: E402
from repro.models.ffn import ffn_apply as ref_ffn  # noqa: E402
from repro.models.norms import layernorm as ref_layernorm  # noqa: E402
from repro.models.norms import rmsnorm as ref_rmsnorm  # noqa: E402
from repro.serving.decode import greedy_decode as ref_greedy_decode  # noqa: E402
from repro.serving.jit_engine import JitIncrementalEngine as RefEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import LayerCfg, uniform_stages  # noqa: E402
from repro_torch.configs.vq_opt_125m import smoke_config as port_smoke  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.embedding import embed_tokens  # noqa: E402
from repro_torch.models.ffn import ffn_apply  # noqa: E402
from repro_torch.models.norms import apply_norm, layernorm  # noqa: E402
from repro_torch.serving.batch_engine import BatchedJitEngine, stack_states  # noqa: E402
from repro_torch.serving.decode import greedy_decode, make_serve_step  # noqa: E402
from repro_torch.serving.jit_engine import JitIncrementalEngine  # noqa: E402

ATOL = 3e-4


@pytest.fixture(scope="module")
def setup():
    cfg, params, np_params = smoke_params()
    return cfg, params, np_params, PT.params_from_numpy(np_params, device="cpu")


def _doc(cfg, seed, b=2, n=40, headroom=64):
    """Seeded tokens and strictly increasing gapped position ids."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, n)).astype(np.int32)
    pos = np.stack([np.sort(rng.choice(cfg.pos_pool - headroom, n, replace=False))
                    for _ in range(b)]).astype(np.int32)
    return toks, pos


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0)


def test_params_from_numpy_keeps_layout_and_bits(setup):
    _, params, np_params, tp = setup
    assert isinstance(tp["stages"], list) and isinstance(tp["stages"][0], tuple)
    cb = tp["stages"][1][0]["mixer"]["vq"]["codebook"]
    np.testing.assert_array_equal(cb.numpy(), np_params["stages"][1][0]["mixer"]["vq"]["codebook"])
    assert tuple(tp["embed"]["pos"].shape) == params["embed"]["pos"].shape
    again = PT.params_from_numpy(tp, device="cpu")  # tensors are copied
    assert again["embed"]["tok"].data_ptr() != tp["embed"]["tok"].data_ptr()


def test_layers_match_reference(setup):
    cfg, params, np_params, tp = setup
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    lp_j = jax.tree.map(lambda a: a[0], params["stages"][1])[0]
    lp_t = PT._index(tp["stages"][1], 0)[0]
    _close(layernorm(lp_t["norm1"], torch.tensor(x)).numpy(),
           ref_layernorm(lp_j["norm1"], jnp.asarray(x)), atol=2e-6)
    _close(apply_norm("layernorm", lp_t["norm2"], torch.tensor(x)).numpy(),
           ref_layernorm(lp_j["norm2"], jnp.asarray(x)), atol=2e-6)
    _close(apply_norm("rmsnorm", lp_t["norm1"], torch.tensor(x)).numpy(),
           ref_rmsnorm(lp_j["norm1"], jnp.asarray(x)), atol=2e-6)
    with pytest.raises(ValueError):
        apply_norm("groupnorm", lp_t["norm1"], torch.tensor(x))
    _close(ffn_apply("gelu", lp_t["ffn"], torch.tensor(x)).numpy(),
           ref_ffn("gelu", lp_j["ffn"], jnp.asarray(x)), atol=2e-5)
    toks, pos = _doc(cfg, 1, n=9)
    _close(embed_tokens(tp["embed"], port_smoke(), torch.tensor(toks), torch.tensor(pos)).numpy(),
           ref_embed(params["embed"], cfg, jnp.asarray(toks), jnp.asarray(pos)), atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_reference(setup, seed):
    cfg, params, _, tp = setup
    toks, pos = _doc(cfg, seed)
    want, aux_j = RT.forward(params, cfg, jnp.asarray(toks), jnp.asarray(pos))
    got, aux = PT.forward(tp, port_smoke(), torch.tensor(toks), torch.tensor(pos))
    assert got.shape == (2, 40, cfg.vocab)
    _close(got.numpy(), want)
    _close(aux["hidden"].numpy(), aux_j["hidden"])
    assert float(aux["aux_loss"]) == 0.0
    # default positions 0..n-1 (learned-style ids)
    want0, _ = RT.forward(params, cfg, jnp.asarray(toks))
    got0, _ = PT.forward(tp, port_smoke(), torch.tensor(toks))
    _close(got0.numpy(), want0)


def test_forward_last_row_matches_engine_full_forward(setup):
    """The model forward and the incremental engine's full forward are two
    routes to the same logits (``tests/test_incremental.py:44``)."""
    _, _, np_params, tp = setup
    cfg = port_smoke()
    toks, pos = _doc(cfg, 2, b=1)
    logits, _ = PT.forward(tp, cfg, torch.tensor(toks), torch.tensor(pos))
    eng = JitIncrementalEngine(np_params, cfg, device="cpu")
    st = eng.full_forward(toks[0], pos[0])
    _close(eng.logits_at(st, 39).numpy(), logits[0, -1].numpy())


def test_unported_modes_raise(setup):
    """Training runs for VQ-OPT and for the MLA mixer; the MLA mixer
    (here on VQ-OPT's GELU FFN, with deepseek-v2's smoke MLA dims), the recurrent
    mixers (hymba, rwkv6 with its channel-mix), vision inputs and windowed
    (ring) caches now work; an unknown mixer raises."""
    _, _, _, tp = setup
    toks = torch.zeros((1, 4), dtype=torch.int64)
    logits, aux = PT.forward(tp, port_smoke(), toks, torch.arange(4)[None] * 3, train=True)
    assert bool(torch.isfinite(logits).all()) and float(aux["aux_loss"]) > 0
    other = dataclasses.replace(port_smoke(), mla=get_config("deepseek-v2-236b", smoke=True).mla,
                                stages=uniform_stages(LayerCfg("mla", "gelu"), 2))
    caches = PT.init_caches(other, 1, 4, device="cpu")
    assert set(caches[0][0]["mix"]) == {"ckv", "krope", "len"}
    assert caches[0][0]["mix"]["ckv"].shape == (2, 1, 4, other.mla.kv_lora)
    params = PT.init_params(other, generator=torch.Generator().manual_seed(0), device="cpu")
    assert set(params["stages"][0][0]["mixer"]) >= {"w_dkv", "w_uk", "w_uv", "vq"}
    logits, aux = PT.forward(params, other, toks, torch.arange(4)[None] * 3, train=True)
    assert bool(torch.isfinite(logits).all()) and float(aux["aux_loss"]) > 0
    logits, _ = PT.forward(params, other, toks, torch.arange(4)[None] * 3)
    assert logits.shape == (1, 4, other.vocab) and bool(torch.isfinite(logits).all())
    unknown = dataclasses.replace(port_smoke(), stages=uniform_stages(LayerCfg("ssm", "gelu"), 2))
    with pytest.raises(ValueError, match="unknown mixer"):
        PT.init_caches(unknown, 1, 4, device="cpu")
    for arch, mixer, ffn in (("hymba-1.5b", "hymba", "swiglu"), ("rwkv6-7b", "rwkv6", "rwkv_cm")):
        cfg = get_config(arch, smoke=True)
        assert {(layer.mixer, layer.ffn) for layer in cfg.layer_list()} == {(mixer, ffn)}
        caches = PT.init_caches(cfg, 1, 4, device="cpu")
        params = PT.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        assert len(caches) == len(params["stages"]) == len(cfg.stages)
        assert set(params["stages"][0][0]["mixer"]) >= ({"wq", "w_xz"} if mixer == "hymba"
                                                        else {"w_r", "w_dec_a"})
    vlm = dataclasses.replace(port_smoke(), input_mode="vlm")
    vp = dict(tp, embed=dict(tp["embed"], vis_proj=torch.eye(vlm.d_model)))
    patches = torch.randn((1, 2, vlm.d_model), generator=torch.Generator().manual_seed(0))
    logits, _ = PT.forward(vp, vlm, toks, torch.arange(4)[None] * 3, patch_embeds=patches)
    assert logits.shape == (1, 6, vlm.vocab) and bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError, match="patch_embeds"):
        PT.forward(vp, vlm, toks, torch.arange(4)[None])
    windowed = dataclasses.replace(
        port_smoke(), stages=uniform_stages(LayerCfg("gqa", "gelu", window=8), 2))
    assert not PT.chunkable(windowed) and PT.chunkable(port_smoke())
    caches = PT.init_caches(windowed, 1, 20, device="cpu")
    assert caches[0][0]["mix"]["k"].shape == (2, 1, 8, 4, 64)  # a ring of 8 slots
    with pytest.raises(ValueError, match="non-windowed"):
        PT.prefill_step(tp, windowed, toks, caches, torch.arange(4)[None])


def test_prefill_then_decode_matches_reference(setup):
    cfg, params, _, tp = setup
    toks, pos = _doc(cfg, 3, n=24)
    cj = RT.init_caches(cfg, 2, 32, dtype=jnp.float32)
    ct = PT.init_caches(port_smoke(), 2, 32, device="cpu")
    lj, cj = RT.prefill_step(params, cfg, jnp.asarray(toks[:, :20]), cj, jnp.asarray(pos[:, :20]))
    lt, ct = PT.prefill_step(tp, port_smoke(), torch.tensor(toks[:, :20]), ct,
                             torch.tensor(pos[:, :20]))
    _close(lt.numpy(), lj)
    for i in range(20, 24):
        lj, cj = RT.decode_step(params, cfg, jnp.asarray(toks[:, i:i + 1]), cj,
                                jnp.asarray(pos[:, i:i + 1]))
        lt, ct = PT.decode_step(tp, port_smoke(), torch.tensor(toks[:, i:i + 1]), ct,
                                torch.tensor(pos[:, i:i + 1]))
        _close(lt.numpy(), lj)
    for sj, st in zip(cj, ct):  # cache trees: same structure and contents
        for lj_, lt_ in zip(sj, st):
            _close(lt_["mix"]["k"].numpy(), lj_["mix"]["k"])
            _close(lt_["mix"]["v"].numpy(), lj_["mix"]["v"])
            np.testing.assert_array_equal(lt_["mix"]["len"].numpy(), np.asarray(lj_["mix"]["len"]))
    # a prefill of the whole prompt equals the forward's logits
    full, _ = PT.forward(tp, port_smoke(), torch.tensor(toks), torch.tensor(pos))
    ct = PT.init_caches(port_smoke(), 2, 24, device="cpu")
    lt, _ = PT.prefill_step(tp, port_smoke(), torch.tensor(toks), ct, torch.tensor(pos))
    _close(lt.numpy(), full.numpy(), atol=2e-5)


def test_greedy_decode_matches_reference(setup):
    cfg, params, _, tp = setup
    toks, pos = _doc(cfg, 4, n=30)
    want, _ = ref_greedy_decode(params, cfg, jnp.asarray(toks), 6, positions=jnp.asarray(pos))
    got, caches = greedy_decode(tp, port_smoke(), torch.tensor(toks), 6,
                                positions=torch.tensor(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
    assert int(caches[0][0]["mix"]["len"][0, 0]) == 30 + 5
    with pytest.raises(ValueError, match="cache_len"):
        greedy_decode(tp, port_smoke(), torch.tensor(toks), 6, cache_len=31)


def test_sampling_step_needs_a_generator(setup):
    _, _, _, tp = setup
    cfg = port_smoke()
    step = make_serve_step(cfg, sample=True, temperature=0.7)
    caches = PT.init_caches(cfg, 1, 4, device="cpu")
    tok, pos = torch.tensor([[3]]), torch.tensor([[5]])
    with pytest.raises(ValueError, match="generator"):
        step(tp, caches, tok, pos)
    a, _ = step(tp, caches, tok, pos, torch.Generator().manual_seed(0))
    b, _ = step(tp, caches, tok, pos, torch.Generator().manual_seed(0))
    assert a.shape == (1, 1) and torch.equal(a, b)
    greedy, _ = make_serve_step(cfg, sample=True, temperature=0.0)(tp, caches, tok, pos)
    logits, _ = make_serve_step(cfg)(tp, caches, tok, pos)
    assert int(greedy) == int(logits.argmax(-1))


def test_kv_export_and_caches_match_reference(setup):
    """``export_kv`` (stable sort, garbage tail included), ``caches_from_kv``
    and ``set_cache_length`` against the reference; ``batch_export_kv``
    slice b equals ``export_kv`` of document b."""
    cfg, params, np_params, _ = setup
    n_cap = 16
    rng = np.random.default_rng(5)
    docs = []
    for _ in range(2):
        toks = rng.integers(0, cfg.vocab, n_cap).astype(np.int32)
        valid = rng.random(n_cap) < 0.7
        pos = np.full(n_cap, cfg.pos_pool - 1, np.int32)
        pos[valid] = np.sort(rng.choice(500, int(valid.sum()), replace=False))[
            rng.permutation(int(valid.sum()))]
        docs.append((toks, pos, valid))
    ref = RefEngine(params, cfg)
    ours = BatchedJitEngine(np_params, port_smoke(), device="cpu")
    states = []
    for toks, pos, valid in docs:
        rs = ref.full_forward(jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(valid))
        ps = ours.full_forward(toks, pos, valid)
        states.append(ps)
        re, pe = ref.export_kv(rs), ours.export_kv(ps)
        for f in ("tokens", "positions", "order", "n_real"):
            np.testing.assert_array_equal(getattr(pe, f).numpy(), np.asarray(getattr(re, f)))
        _close(pe.k.numpy(), re.k)
        _close(pe.v.numpy(), re.v)
        cj = RT.set_cache_length(RT.caches_from_kv(cfg, re.k[:, None], re.v[:, None],
                                                   jnp.zeros((1,), jnp.int32), seq_len=20), 7)
        ct = PT.set_cache_length(PT.caches_from_kv(port_smoke(), pe.k[:, None], pe.v[:, None],
                                                   torch.zeros(1, dtype=torch.int32),
                                                   seq_len=20), 7)
        for sj, st in zip(cj, ct):
            for lj_, lt_ in zip(sj, st):
                _close(lt_["mix"]["k"].numpy(), lj_["mix"]["k"])
                np.testing.assert_array_equal(lt_["mix"]["len"].numpy(),
                                              np.asarray(lj_["mix"]["len"]))
    be = ours.batch_export_kv(stack_states(states))
    for b, st in enumerate(states):
        one = ours.export_kv(st)
        for f in one._fields:
            assert torch.equal(getattr(be, f)[b], getattr(one, f)), f
    with pytest.raises(ValueError, match="layers"):
        PT.caches_from_kv(port_smoke(), pe.k[:1, None], pe.v[:1, None], torch.zeros(1))
