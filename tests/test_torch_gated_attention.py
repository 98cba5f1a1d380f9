"""The port's gated σ-attention (``kernels/gated_attention``) and its route
in ``models/attention.full_attention`` against the JAX package's Pallas
kernel (interpret mode on the CPU), its plain reference and the σ
``attention_core``, on seeded numpy inputs: within 1e-6 (both sum the same
f32 products; only the order differs)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.gated_attention import (  # noqa: E402
    gated_attention as jax_gated_attention, gated_attention_ref as jax_ref,
)
from repro.models import attention as ref_attn  # noqa: E402
from repro_torch.kernels.gated_attention import (  # noqa: E402
    LAUNCHES, gated_attention, gated_attention_bh, gated_attention_ref,
)
from repro_torch.models import attention as port_attn  # noqa: E402

ATOL = 1e-6


def _qkv(seed, b, n, H, Hkv, dh, scale=0.5):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    return f(b, n, H, dh), f(b, n, Hkv, dh), f(b, n, Hkv, dh)


@pytest.mark.parametrize("b,n,H,Hkv,dh", [(2, 128, 4, 4, 64),
                                           (1, 200, 8, 4, 64),   # ragged n, GQA rep 2
                                           (2, 37, 4, 2, 32),    # ragged, rep 2, dh 32
                                           (1, 1, 2, 2, 64)])    # one token
def test_gated_attention_matches_jax_kernel(b, n, H, Hkv, dh):
    q, k, v = _qkv(n + H, b, n, H, Hkv, dh)
    want = jax_gated_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               block_q=64, block_k=64)
    got = gated_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v))
    assert got.shape == (b, n, H * dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("nq,nk", [(50, 50), (70, 40), (40, 70)])
def test_gated_attention_bh_matches_jax_ref_with_nq_ne_nk(nq, nk):
    """The kernel's own layout, including nq != nk (rows past nk attend
    every key and divide by nk)."""
    rng = np.random.default_rng(nq * nk)
    q = (rng.standard_normal((3, nq, 64)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((3, nk, 64)) * 0.5).astype(np.float32)
    v = rng.standard_normal((3, nk, 64)).astype(np.float32)
    want = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = gated_attention_bh(torch.tensor(q), torch.tensor(k), torch.tensor(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert torch.equal(got, gated_attention_ref(torch.tensor(q), torch.tensor(k),
                                                torch.tensor(v)))


@pytest.mark.parametrize("Hkv", [4, 2])
def test_gated_attention_matches_sigma_attention_core(Hkv):
    b, n, H, dh = 2, 96, 4, 64
    q, k, v = _qkv(Hkv, b, n, H, Hkv, dh)
    mask = ref_attn.make_mask(n, n, causal=True, window=None)
    want = ref_attn.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   mask, softmax=False)
    got = gated_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_full_attention_routes_like_the_reference():
    """σ causal unwindowed -> the kernel route; softmax, windows and padding
    masks -> the dense core; all equal the reference's dense results."""
    b, n, H, dh = 2, 40, 4, 32
    q, k, v = _qkv(3, b, n, H, 2, dh)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    valid = np.ones((b, n), bool)
    valid[1, 30:] = False
    cases = [dict(softmax=False), dict(softmax=True), dict(softmax=False, window=8),
             dict(softmax=True, window=8)]
    for kw in cases:
        want = ref_attn.full_attention(jq, jk, jv, causal=True, **kw)
        got = port_attn.full_attention(tq, tk, tv, causal=True, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=0,
                                   err_msg=str(kw))
    for softmax in (False, True):
        want = ref_attn.full_attention(jq, jk, jv, softmax=softmax,
                                       valid_k=jnp.asarray(valid))
        got = port_attn.full_attention(tq, tk, tv, softmax=softmax,
                                       valid_k=torch.tensor(valid))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=0)


def test_long_dense_sequences_name_the_later_slice(monkeypatch):
    """Past STREAM_THRESHOLD the dense cases (softmax, σ with a window) take
    ``flash.streaming_attention`` and equal the dense core within 2e-5
    (``tests/test_models.py:130-133``); the σ kernel route has no length
    limit."""
    monkeypatch.setattr(port_attn, "STREAM_THRESHOLD", 16)
    q, k, v = (torch.tensor(a) for a in _qkv(0, 1, 20, 4, 2, 8))
    calls = []
    stream = port_attn.streaming_attention
    monkeypatch.setattr(port_attn, "streaming_attention",
                        lambda *a, **kw: calls.append(kw) or stream(*a, **kw))
    for kw in (dict(softmax=True), dict(softmax=False, window=6), dict(softmax=True, window=6)):
        got = port_attn.full_attention(q, k, v, **kw)
        mask = port_attn.make_mask(20, 20, causal=True, window=kw.get("window"))
        want = port_attn.attention_core(q, k, v, mask, softmax=kw["softmax"])
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=2e-5)
    assert len(calls) == 3
    port_attn.full_attention(q, k, v, softmax=False)
    assert len(calls) == 3  # the kernel route


@pytest.mark.parametrize("b,n,H,Hkv,dh", [(1, 64, 2, 2, 128),   # phi4-mini's head dim
                                           (1, 40, 2, 2, 256),   # gemma3's, ragged n
                                           (1, 48, 6, 2, 128)])  # GQA rep 3, as phi4's 24/8
def test_wide_heads_match_jax_kernel(b, n, H, Hkv, dh):
    """The plain version at the head dims the kernel gained (128, 256)
    against the reference's Pallas kernel in interpret mode."""
    q, k, v = _qkv(dh + n, b, n, H, Hkv, dh)
    want = jax_gated_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               block_q=32, block_k=32)
    got = gated_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v))
    assert got.shape == (b, n, H * dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_make_mask_matches_reference():
    valid = np.array([[1, 1, 0, 1, 1]], bool)
    for kw in (dict(causal=True, window=None), dict(causal=True, window=2),
               dict(causal=False, window=None)):
        want = ref_attn.make_mask(3, 5, q_offset=2, valid_k=jnp.asarray(valid), **kw)
        got = port_attn.make_mask(3, 5, q_offset=2, valid_k=torch.tensor(valid), **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_calls_do_not_count():
    before = dict(LAUNCHES)
    q, k, v = (torch.tensor(a) for a in _qkv(0, 1, 8, 2, 2, 64))
    gated_attention(q, k, v)
    assert LAUNCHES == before
