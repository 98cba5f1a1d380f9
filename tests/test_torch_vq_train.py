"""Training-mode VQ (``core.vq.forward_train``, the Gumbel-softmax
straight-through estimator) and the attention layer's training path
against the JAX package, fed the reference's own Gumbel noise: codes
equal (a code may differ only where the top two Gumbel logits lie within
1e-5, counted), ``x_st``, the auxiliary loss and the gradients in x and
the codebook within 2e-6 (f32, another summation order)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import smoke_params  # noqa: E402
from repro.core import vq as ref_vq  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro_torch.configs.vq_opt_125m import smoke_config as port_smoke  # noqa: E402
from repro_torch.core import vq  # noqa: E402
from repro_torch.models import attention as port_attn  # noqa: E402
from repro_torch.models.transformer import params_from_numpy  # noqa: E402

ATOL = 2e-6
TIE = 1e-5


def _inputs(seed, lead=(2, 24), d=256, h=2, Q=64):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((*lead, d)) * 0.7).astype(np.float32)
    cb = (rng.standard_normal((h, Q, d // h)) * 0.5).astype(np.float32)
    cot = rng.standard_normal((*lead, d)).astype(np.float32)  # d loss / d x_st
    return x, cb, cot


def _ties(x, cb, noise, temperature):
    s = np.asarray(ref_vq.scores(ref_vq.VQParams(codebook=jnp.asarray(cb)), jnp.asarray(x)))
    top2 = np.sort((s + noise) / temperature, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) < TIE


@pytest.mark.parametrize("temperature,beta,lead", [(1.0, 0.25, (2, 24)), (0.5, 1.0, (3, 7)),
                                                   (2.0, 0.25, (1, 1))])
def test_forward_train_matches_the_reference_with_its_noise(temperature, beta, lead):
    x, cb, cot = _inputs(int(temperature * 10) + len(lead), lead)
    rcfg = ref_vq.VQConfig(n_heads=2, codebook_size=64, commitment_beta=beta,
                           temperature=temperature)
    pcfg = vq.VQConfig(n_heads=2, codebook_size=64, commitment_beta=beta,
                       temperature=temperature)
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.gumbel(key, (*lead, 2, 64), dtype=jnp.float32))

    def ref_loss(x, cb):
        x_st, idx, aux = ref_vq.forward_train(ref_vq.VQParams(codebook=cb), x, rcfg, rng=key)
        return jnp.sum(x_st * cot) + aux, (x_st, idx, aux)

    (_, (x_st_j, idx_j, aux_j)), (gx_j, gcb_j) = jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(cb))
    xt, cbt = (torch.tensor(a, requires_grad=True) for a in (x, cb))
    x_st, idx, aux = vq.forward_train({"codebook": cbt}, xt, pcfg, noise=torch.tensor(noise))
    (torch.sum(x_st * torch.tensor(cot)) + aux).backward()

    flips = idx.numpy() != np.asarray(idx_j)
    assert not (flips & ~_ties(x, cb, noise, temperature)).any()
    assert idx.dtype == torch.int32 and idx.shape == (*lead, 2)
    if not flips.any():  # a flip at a near tie changes the values by design
        np.testing.assert_allclose(x_st.detach().numpy(), np.asarray(x_st_j), atol=ATOL, rtol=0)
        np.testing.assert_allclose(float(aux.detach()), float(aux_j), atol=ATOL, rtol=1e-6)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), atol=ATOL, rtol=0)
        np.testing.assert_allclose(cbt.grad.numpy(), np.asarray(gcb_j), atol=ATOL, rtol=0)


def test_straight_through_values_and_gradient_routes():
    """``x_st`` is the hard code's vector in value and passes the cotangent
    to x unchanged (straight through) and nothing to the codebook, which
    gets its gradient from the auxiliary loss (the codebook term through
    the soft weights)."""
    x, cb, cot = _inputs(3)
    cfg = vq.VQConfig()
    xt, cbt = (torch.tensor(a, requires_grad=True) for a in (x, cb))
    noise = vq.gumbel(torch.Generator().manual_seed(0), (2, 24, 2, 64))
    x_st, idx, aux = vq.forward_train({"codebook": cbt}, xt, cfg, noise=noise)
    hard = vq.lookup({"codebook": torch.tensor(cb)}, idx)
    np.testing.assert_allclose(x_st.detach().numpy(), hard.numpy(), atol=ATOL, rtol=0)
    gx, gcb = torch.autograd.grad(torch.sum(x_st * torch.tensor(cot)), (xt, cbt),
                                  allow_unused=True)
    assert torch.equal(gx, torch.tensor(cot)) and gcb is None
    gx_aux, gcb_aux = torch.autograd.grad(aux, (xt, cbt))
    assert bool(gx_aux.abs().max() > 0) and bool(gcb_aux.abs().max() > 0)


def test_noise_comes_from_the_generator_or_not_at_all():
    x, cb, _ = _inputs(4)
    params, cfg = {"codebook": torch.tensor(cb)}, vq.VQConfig()
    xt = torch.tensor(x)
    a = vq.forward_train(params, xt, cfg, generator=torch.Generator().manual_seed(5))
    b = vq.forward_train(params, xt, cfg, generator=torch.Generator().manual_seed(5))
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    plain = vq.forward_train(params, xt, cfg)
    assert torch.equal(plain[1], vq.assign(params, xt))
    assert not torch.equal(a[1], plain[1])  # the noise moved some codes


def test_gumbel_noise_has_the_standard_gumbel_moments():
    g = vq.gumbel(torch.Generator().manual_seed(0), (200_000,))
    assert torch.isfinite(g).all()
    assert abs(float(g.mean()) - 0.5772) < 0.01 and abs(float(g.var()) - np.pi ** 2 / 6) < 0.03


def test_attention_layer_trains_like_the_reference():
    """``attn_apply(train=True)`` on a smoke layer's weights with the
    reference's noise for ``vq_rng``: the output, the VQ loss and every
    parameter's and the input's gradient within 2e-6 (the port's σ core is
    the ``gated_attention`` Function, the reference's the dense core)."""
    cfg_j, params, np_params = smoke_params()
    cfg = port_smoke()
    layer = cfg.layer_list()[0]
    lp_np = jax.tree.map(lambda a: a[0], np_params["stages"][0][0]["mixer"])
    lp_j = jax.tree.map(lambda a: a[0], params["stages"][0][0]["mixer"])
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((2, 40, cfg.d_model)) * 0.5).astype(np.float32)
    pos = np.sort(rng.choice(cfg.pos_pool, (2, 40)), axis=-1).astype(np.int32)
    cot = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    noise = jax.random.gumbel(key, (2, 40, cfg.vqt.n_heads, cfg.vqt.codebook_size))

    def ref_loss(lp, x):
        out, aux = ref_attn.attn_apply(lp, cfg_j, layer, x, jnp.asarray(pos), train=True,
                                       vq_rng=key)
        return jnp.sum(out * cot) + aux, (out, aux)

    (_, (out_j, aux_j)), (glp_j, gx_j) = jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True)(lp_j, jnp.asarray(x))
    lp = params_from_numpy(lp_np, device="cpu")
    leaves = {k: v.requires_grad_() for k, v in lp.items() if k != "vq"}
    leaves["codebook"] = lp["vq"]["codebook"].requires_grad_()
    xt = torch.tensor(x, requires_grad=True)
    out, aux = port_attn.attn_apply(lp, cfg, layer, xt, torch.tensor(pos), train=True,
                                    vq_noise=torch.tensor(np.asarray(noise)))
    (torch.sum(out * torch.tensor(cot)) + aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(aux.detach()), float(aux_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), atol=ATOL, rtol=0)
    for name, t in leaves.items():
        want = glp_j["vq"].codebook if name == "codebook" else glp_j[name]
        scale = max(1.0, float(np.abs(np.asarray(want)).max()))
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=ATOL * scale,
                                   rtol=0, err_msg=name)
