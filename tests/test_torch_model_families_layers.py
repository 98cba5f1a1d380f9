"""The layers the dense-attention families add to the port, against the
reference's: RoPE, RMSNorm, each FFN kind, multi-codebook embeddings and
the vision prefix, ``flash.streaming_attention`` (both accumulation modes,
with and without a window, within 2e-5 of the reference's and of the dense
core), h2o-danube's ring-buffer decode past its window, and a config whose
head dim is set apart from d_model (H·dh != d_model, as gemma3's)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import arch_params  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.embedding import embed_tokens as ref_embed, merge_vision as ref_merge  # noqa: E402
from repro.models.ffn import ffn_apply as ref_ffn, ffn_init as ref_ffn_init  # noqa: E402
from repro.models.flash import streaming_attention as ref_stream  # noqa: E402
from repro.models.norms import rmsnorm as ref_rmsnorm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as port_attn  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.embedding import embed_tokens, merge_vision  # noqa: E402
from repro_torch.models.ffn import ffn_apply  # noqa: E402
from repro_torch.models.flash import streaming_attention  # noqa: E402
from repro_torch.models.norms import apply_norm, norm_init, rmsnorm  # noqa: E402



def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("window", [None, 16])
def test_streaming_attention_matches_reference(softmax, window):
    """n = 100 in 32-key blocks (a ragged last block), GQA rep 2, against
    the reference's and the dense core; with q_block = 32 the query blocks
    skip the kv blocks they cannot reach and still equal the dense core."""
    b, n, H, Hkv, dh = 2, 100, 4, 2, 16
    q, k, v = _rand(0, b, n, H, dh), _rand(1, b, n, Hkv, dh), _rand(2, b, n, Hkv, dh)
    want = ref_stream(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                      window=window, softmax=softmax, kv_block=32)
    tq, tk, tv = torch.tensor(q), torch.tensor(k), torch.tensor(v)
    got = streaming_attention(tq, tk, tv, causal=True, window=window, softmax=softmax,
                              kv_block=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    mask = port_attn.make_mask(n, n, causal=True, window=window)
    dense = port_attn.attention_core(tq, tk, tv, mask, softmax=softmax)
    for q_block in (1024, 32):
        got = streaming_attention(tq, tk, tv, causal=True, window=window, softmax=softmax,
                                  kv_block=32, q_block=q_block)
        np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("theta", [10000.0, 1000000.0])
def test_apply_rope_matches_reference(theta):
    x = _rand(3, 2, 9, 4, 32)
    pos = np.sort(np.random.default_rng(4).choice(5000, (2, 9)), axis=1).astype(np.int32)
    want = ref_attn.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = port_attn.apply_rope(torch.tensor(x), torch.tensor(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(port_attn.rope_freqs(32, theta).numpy(),
                                  np.asarray(ref_attn.rope_freqs(32, theta)))


def test_rmsnorm_matches_reference():
    x = _rand(5, 2, 7, 48, scale=3.0)
    scale = _rand(6, 48)
    want = ref_rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    got = rmsnorm({"scale": torch.tensor(scale)}, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=0)
    assert set(norm_init("rmsnorm", 48)) == {"scale"}
    ones = apply_norm("rmsnorm", norm_init("rmsnorm", 48), torch.tensor(x))
    np.testing.assert_allclose(ones.numpy(), np.asarray(
        ref_rmsnorm({"scale": jnp.ones(48)}, jnp.asarray(x))), atol=2e-6, rtol=0)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "relu", "relu2"])
def test_ffn_kinds_match_reference(kind):
    params = jax.device_get(ref_ffn_init(jax.random.PRNGKey(7), kind, 48, 96))
    x = _rand(8, 2, 5, 48)
    want = ref_ffn(kind, params, jnp.asarray(x))
    got = ffn_apply(kind, _t(params), torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_codebook_embeddings_and_vision_prefix_match_reference():
    cfg = get_config("musicgen-large", smoke=True)
    cfg_j = ref_get_config("musicgen-large", smoke=True)
    embed = {"tok": _rand(9, 4, cfg.vocab, 256), "pos": _rand(10, cfg.max_seq, 256)}
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (2, 6, 4)).astype(np.int32)
    pos = np.arange(6, dtype=np.int32)[None].repeat(2, 0) * 7
    want = ref_embed({k: jnp.asarray(v) for k, v in embed.items()}, cfg_j, jnp.asarray(toks),
                     jnp.asarray(pos))
    got = embed_tokens(_t(embed), cfg, torch.tensor(toks), torch.tensor(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7, rtol=0)
    with pytest.raises(ValueError, match="n_codebooks"):
        embed_tokens(_t(embed), cfg, torch.tensor(toks[..., 0]), torch.tensor(pos))
    vis = {"vis_proj": _rand(11, 256, 256, scale=256 ** -0.5)}
    patches, x = _rand(12, 2, 3, 256), _rand(13, 2, 5, 256)
    want = ref_merge({"vis_proj": jnp.asarray(vis["vis_proj"])}, jnp.asarray(patches),
                     jnp.asarray(x))
    got = merge_vision(_t(vis), torch.tensor(patches), torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("vqt", [False, True])
def test_danube_ring_buffer_matches_forward(vqt):
    """80 tokens > the smoke window of 64: the ring-buffer decode equals the
    windowed forward (2e-3, the reference's bound), whose logits match the
    reference's within 3e-4."""
    cfg_j, params, np_params = arch_params("h2o-danube-1.8b", vqt)
    cfg = get_config("h2o-danube-1.8b", smoke=True, vqt=vqt)
    assert all(layer.window == 64 for layer in cfg.layer_list())
    tp = PT.params_from_numpy(np_params, device="cpu")
    toks = np.random.default_rng(12).integers(0, cfg.vocab, (1, 80)).astype(np.int32)
    full, _ = PT.forward(tp, cfg, torch.tensor(toks))
    want, _ = RT.forward(params, cfg_j, jnp.asarray(toks))
    np.testing.assert_allclose(full.numpy(), np.asarray(want), atol=3e-4, rtol=0)
    caches = PT.init_caches(cfg, 1, 80, device="cpu")
    assert caches[0][0]["mix"]["k"].shape[2] == 64
    for i in range(80):
        step, caches = PT.decode_step(tp, cfg, torch.tensor(toks[:, i:i + 1]), caches,
                                      torch.full((1, 1), i, dtype=torch.int32))
    assert int(caches[0][0]["mix"]["len"][0, 0]) == 80
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("vqt", [False, True])
def test_head_dim_apart_from_d_model_matches_reference(vqt):
    """phi4-mini's smoke config with head_dim = 128 (4 heads: H·dh = 512,
    d_model 256), as gemma3's heads are set: forward within 3e-4 of the
    reference's and decode within 2e-3 of the port's forward."""
    cfg_j = dataclasses.replace(ref_get_config("phi4-mini-3.8b", smoke=True, vqt=vqt), head_dim=128)
    cfg = dataclasses.replace(get_config("phi4-mini-3.8b", smoke=True, vqt=vqt), head_dim=128)
    _, params, np_params = arch_params("phi4-mini-3.8b", cfg=cfg_j)
    tp = PT.params_from_numpy(np_params, device="cpu")
    assert tp["stages"][0][0]["mixer"]["wq"].shape == (1, 256, 512)
    toks = np.random.default_rng(13).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    pos = (np.arange(12)[None].repeat(2, 0) * 5).astype(np.int32)
    want, _ = RT.forward(params, cfg_j, jnp.asarray(toks), jnp.asarray(pos))
    got, _ = PT.forward(tp, cfg, torch.tensor(toks), torch.tensor(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-4, rtol=0)
    caches = PT.init_caches(cfg, 2, 12, device="cpu")
    for i in range(12):
        step, caches = PT.decode_step(tp, cfg, torch.tensor(toks[:, i:i + 1]), caches,
                                      torch.tensor(pos[:, i:i + 1]))
    np.testing.assert_allclose(step[:, 0].numpy(), got[:, -1].numpy(), atol=2e-3, rtol=2e-3)
