"""The gradient of the port's σ-attention on the CPU against ``jax.grad`` of
the JAX package's: ``gated_attention_bwd_ref`` (the written-out backward,
the plain version of ``csrc/gated_attention_bwd.cu``) against the
gradient of the reference's ``gated_attention_ref``, and autograd through
the port's wrappers (the ``torch.autograd.Function``, GQA through the
model layout) against the gradient of the reference's σ ``attention_core``,
which the reference's training differentiates. Tolerance 2e-6 absolute on
gradients of magnitude ~1: both sum the same f32 products in another
order."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.gated_attention import gated_attention_ref as jax_ref  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro_torch.kernels.gated_attention import (  # noqa: E402
    LAUNCHES, gated_attention, gated_attention_bh, gated_attention_bwd_bh,
    gated_attention_bwd_ref,
)

ATOL = 2e-6


def _inputs(seed, BH, nq, nk, dh=64):
    rng = np.random.default_rng(seed)
    f = lambda *s, a=1.0: (rng.standard_normal(s) * a).astype(np.float32)  # noqa: E731
    return f(BH, nq, dh, a=0.5), f(BH, nk, dh, a=0.5), f(BH, nk, dh), f(BH, nq, dh)


def _jax_grads(q, k, v, do):
    loss = lambda q, k, v: jnp.sum(jax_ref(q, k, v) * do)  # noqa: E731
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]


@pytest.mark.parametrize("BH,nq,nk", [
    (3, 37, 37),    # ragged, below one 64-row tile
    (2, 1, 1),      # one row
    (2, 130, 130),  # three tiles, the last of two rows
    (4, 64, 64),    # one whole tile
    (2, 50, 30),    # nq > nk: rows past nk attend every key, divide by nk
    (2, 30, 50),    # nq < nk
])
def test_bwd_ref_matches_jax_grad(BH, nq, nk):
    q, k, v, do = _inputs(BH * 1000 + nq + nk, BH, nq, nk)
    want = _jax_grads(q, k, v, do)
    got = gated_attention_bwd_ref(*map(torch.tensor, (q, k, v, do)))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("n", [1, 37, 130])
def test_autograd_of_the_kernel_layout_matches_jax_grad(n):
    """``gated_attention_bh`` under autograd: the Function's backward on CPU
    tensors is ``gated_attention_bwd_ref``, bit for bit."""
    q, k, v, do = _inputs(n, 3, n, n)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    (gated_attention_bh(*leaves) * torch.tensor(do)).sum().backward()
    for leaf, w in zip(leaves, _jax_grads(q, k, v, do)):
        np.testing.assert_allclose(leaf.grad.numpy(), w, atol=ATOL, rtol=0)
    want = gated_attention_bwd_bh(*map(torch.tensor, (q, k, v, do)))
    assert all(torch.equal(leaf.grad, w) for leaf, w in zip(leaves, want))


@pytest.mark.parametrize("b,n,H,Hkv", [(2, 37, 4, 4), (1, 70, 8, 4), (2, 1, 4, 2)])
def test_autograd_of_the_model_layout_matches_the_references_sigma_core(b, n, H, Hkv):
    """The model layout [b, n, H, dh] with GQA: the gradient of a repeated
    k / v head sums over its repeats, as ``jnp.repeat``'s does."""
    rng = np.random.default_rng(b * n * H)
    q = (rng.standard_normal((b, n, H, 64)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, n, Hkv, 64)) * 0.5).astype(np.float32)
    v = rng.standard_normal((b, n, Hkv, 64)).astype(np.float32)
    go = rng.standard_normal((b, n, H * 64)).astype(np.float32)
    mask = ref_attn.make_mask(n, n, causal=True, window=None)
    loss = lambda q, k, v: jnp.sum(  # noqa: E731
        ref_attn.attention_core(q, k, v, mask, softmax=False) * go)
    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    (gated_attention(*leaves) * torch.tensor(go)).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=ATOL, rtol=0)


def test_cpu_backward_launches_no_kernel():
    q, k, v, do = _inputs(0, 2, 16, 16)
    before = dict(LAUNCHES)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    (gated_attention_bh(*leaves) * torch.tensor(do)).sum().backward()
    gated_attention_bwd_bh(*map(torch.tensor, (q, k, v, do)))
    assert LAUNCHES == before
