"""``repro_torch.models.mla`` against ``repro.models.mla`` on layer 0 of the
reference's deepseek-v2 smoke weights (PRNGKey(1)): the naive form through
the streaming path against the dense scores (``STREAM_THRESHOLD`` lowered)
within 2e-5 (``tests/test_models.py:130-133``), each path against the
reference's, softmax and σ; the absorbed decode step by step against the
reference's (output and latent cache); the cache's shapes and dtype; and
the write slot clamped at S - 1 once the cache is full."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import arch_params  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro.models import mla as ref_mla  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import mla  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402


@functools.lru_cache(maxsize=None)
def _layer(vqt):
    """(port cfg, reference cfg, layer 0's reference mixer params, its port
    params)."""
    cfg = get_config("deepseek-v2-236b", smoke=True, vqt=vqt)
    cfg_j, params, np_params = arch_params("deepseek-v2-236b", vqt)
    first = jax.tree.map(lambda a: a[0], params["stages"][0][0]["mixer"])
    tp = PT.params_from_numpy(np_params, device="cpu")
    return cfg, cfg_j, first, PT._index(tp["stages"][0], 0)[0]["mixer"]


def _variant(cfg, softmax):
    """The smoke config with softmax or σ weights and no VQ (a code could
    flip between two float orders)."""
    return dataclasses.replace(cfg, attn_softmax=softmax, vqt=None)


def _x(seed, cfg, n, b=2):
    return np.random.default_rng(seed).standard_normal((b, n, cfg.d_model)).astype(np.float32)


def _pos(b, n, start=0):
    return np.arange(start, start + n)[None].repeat(b, 0).astype(np.int32)


@pytest.mark.parametrize("softmax", [True, False])
def test_streaming_path_equals_dense_and_the_reference(monkeypatch, softmax):
    cfg0, cfg_j0, pj, pt = _layer(False)
    cfg, cfg_j = _variant(cfg0, softmax), _variant(cfg_j0, softmax)
    pj = {k: v for k, v in pj.items() if k != "vq"}
    pt = {k: v for k, v in pt.items() if k != "vq"}
    layer = cfg.layer_list()[0]
    n = 40
    x, pos = _x(0, cfg, n), _pos(2, n)
    dense, _ = mla.mla_apply(pt, cfg, layer, torch.tensor(x), torch.tensor(pos))
    want_dense, _ = ref_mla.mla_apply(pj, cfg_j, layer, jnp.asarray(x), jnp.asarray(pos))
    monkeypatch.setattr(attention, "STREAM_THRESHOLD", 16)
    monkeypatch.setattr(ref_attention, "STREAM_THRESHOLD", 16)
    stream, _ = mla.mla_apply(pt, cfg, layer, torch.tensor(x), torch.tensor(pos))
    want_stream, _ = ref_mla.mla_apply(pj, cfg_j, layer, jnp.asarray(x), jnp.asarray(pos))
    np.testing.assert_allclose(stream.numpy(), dense.numpy(), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(dense.numpy(), np.asarray(want_dense), atol=1e-5, rtol=0)
    np.testing.assert_allclose(stream.numpy(), np.asarray(want_stream), atol=1e-5, rtol=0)


def test_forward_with_vq_matches_the_reference_and_refuses_training():
    """Inference with VQ, then the training-mode layer: given the
    reference's Gumbel noise for its ``vq_rng``, the straight-through output
    and the VQ aux loss within 1e-5 of the reference's ``mla_apply(...,
    train=True)`` (no near tie: the top two Gumbel logits of every token
    and head lie more than 1e-5 apart)."""
    from repro_torch.core import vq as port_vq

    cfg, cfg_j, pj, pt = _layer(True)
    layer = cfg.layer_list()[0]
    x, pos = _x(1, cfg, 24), _pos(2, 24)
    got, aux = mla.mla_apply(pt, cfg, layer, torch.tensor(x), torch.tensor(pos))
    want, _ = ref_mla.mla_apply(pj, cfg_j, layer, jnp.asarray(x), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-4, rtol=0)
    assert float(aux) == 0.0
    key = jax.random.PRNGKey(4)
    want, want_aux = ref_mla.mla_apply(pj, cfg_j, layer, jnp.asarray(x), jnp.asarray(pos),
                                       train=True, vq_rng=key)
    noise = np.asarray(jax.random.gumbel(key, (2, 24, cfg.vqt.n_heads, cfg.vqt.codebook_size)))
    scores = []
    real = port_vq.forward_train

    def spy(params, o, vcfg, **kw):
        scores.append(port_vq.scores(params, o.detach()) + kw["noise"])
        return real(params, o, vcfg, **kw)

    port_vq.forward_train = spy
    try:
        got, aux = mla.mla_apply(pt, cfg, layer, torch.tensor(x), torch.tensor(pos), train=True,
                                 vq_noise=torch.tensor(noise))
    finally:
        port_vq.forward_train = real
    top2 = torch.topk(scores[0], 2, dim=-1).values
    assert bool(((top2[..., 0] - top2[..., 1]) > 1e-5).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("vqt", [False, True])
def test_decode_matches_reference_step_by_step(vqt):
    """Eight steps into an 8-slot cache from empty: each output within 3e-4
    of the reference's, the latent cache rows within 1e-5."""
    cfg, cfg_j, pj, pt = _layer(vqt)
    layer = cfg.layer_list()[0]
    S = 8
    cj = ref_mla.mla_cache_init(cfg_j, layer, 2, S, dtype=jnp.float32)
    ct = mla.mla_cache_init(cfg, layer, 2, S, device="cpu")
    for i in range(S):
        x, pos = _x(10 + i, cfg, 1), _pos(2, 1, i)
        oj, cj = ref_mla.mla_decode(pj, cfg_j, layer, jnp.asarray(x), cj, jnp.asarray(pos))
        ot, ct = mla.mla_decode(pt, cfg, layer, torch.tensor(x), ct, torch.tensor(pos))
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=3e-4, rtol=0)
    for key in ("ckv", "krope"):
        np.testing.assert_allclose(ct[key].numpy(), np.asarray(cj[key]), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ct["len"].numpy(), np.asarray(cj["len"]))


def test_cache_shapes_and_dtype():
    cfg = get_config("deepseek-v2-236b", smoke=True)
    layer = cfg.layer_list()[0]
    c = mla.mla_cache_init(cfg, layer, 3, 17, device="cpu")
    assert c["ckv"].shape == (3, 17, cfg.mla.kv_lora) and c["krope"].shape == (3, 17, 16)
    assert c["ckv"].dtype == c["krope"].dtype == torch.float32
    assert c["len"].dtype == torch.int32 and c["len"].tolist() == [0, 0, 0]
    full = get_config("deepseek-v2-236b")
    c = mla.mla_cache_init(full, full.layer_list()[0], 1, 4, device="cpu")
    assert c["ckv"].shape[-1] + c["krope"].shape[-1] == 576  # floats a token


def test_full_cache_writes_its_last_slot():
    """With len == S the new token goes to slot S - 1 (never -1), attends all
    S slots, and len keeps counting, as the reference's."""
    cfg, cfg_j, pj, pt = _layer(True)
    layer = cfg.layer_list()[0]
    S = 4
    rng = np.random.default_rng(5)
    ckv = rng.standard_normal((2, S, cfg.mla.kv_lora)).astype(np.float32)
    krope = rng.standard_normal((2, S, cfg.mla.rope_dim)).astype(np.float32)
    length = np.full((2,), S, np.int32)
    x, pos = _x(20, cfg, 1), _pos(2, 1, S)
    oj, cj = ref_mla.mla_decode(pj, cfg_j, layer, jnp.asarray(x),
                                {"ckv": jnp.asarray(ckv), "krope": jnp.asarray(krope),
                                 "len": jnp.asarray(length)}, jnp.asarray(pos))
    ot, ct = mla.mla_decode(pt, cfg, layer, torch.tensor(x),
                            {"ckv": torch.tensor(ckv), "krope": torch.tensor(krope),
                             "len": torch.tensor(length)}, torch.tensor(pos))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=3e-4, rtol=0)
    np.testing.assert_array_equal(ct["ckv"][:, :S - 1].numpy(), ckv[:, :S - 1])
    assert not np.array_equal(ct["ckv"][:, S - 1].numpy(), ckv[:, S - 1])
    np.testing.assert_allclose(ct["ckv"].numpy(), np.asarray(cj["ckv"]), atol=1e-5, rtol=0)
    assert ct["len"].tolist() == [S + 1, S + 1]
