"""The port's VQ assignment (``kernels/vq_assign`` and ``core/vq``) against
the JAX package's Pallas kernel (interpret mode on the CPU), its plain
reference and ``repro.core.vq``, on seeded numpy inputs. Indices must be
equal; ``x_q`` within 1e-6 (it is a gathered codebook row in both)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import vq as ref_vq  # noqa: E402
from repro.kernels.vq_assign import (  # noqa: E402
    vq_assign as jax_vq_assign, vq_assign_batched as jax_vq_assign_batched,
    vq_assign_ref as jax_vq_assign_ref,
)
from repro_torch.core import vq as port_vq  # noqa: E402
from repro_torch.kernels.vq_assign import (  # noqa: E402
    LAUNCHES, codebook_bias, vq_assign, vq_assign_batched, vq_assign_ref,
)


def _inputs(seed, lead, hq, Q, dv):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*lead, hq * dv)).astype(np.float32)
    cb = (rng.standard_normal((hq, Q, dv)) * 0.5).astype(np.float32)
    return x, cb


@pytest.mark.parametrize("N,hq,Q,dv", [(64, 2, 64, 384), (257, 4, 64, 64),
                                        (8, 1, 128, 256), (37, 3, 48, 24)])
def test_vq_assign_matches_jax_kernel(N, hq, Q, dv):
    x, cb = _inputs(N + Q, (N,), hq, Q, dv)
    idx_j, xq_j = jax_vq_assign(jnp.asarray(x), jnp.asarray(cb), block_n=32)
    idx_p, xq_p = vq_assign(torch.tensor(x), torch.tensor(cb))
    np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(xq_p.numpy(), np.asarray(xq_j), atol=1e-6, rtol=0)
    assert idx_p.dtype == torch.int32 and xq_p.shape == (N, hq * dv)


@pytest.mark.parametrize("B,N,hq,Q,dv", [(2, 13, 3, 48, 24), (3, 7, 1, 40, 96),
                                          (1, 257, 2, 96, 40)])
def test_vq_assign_batched_matches_jax_kernel_odd_shapes(B, N, hq, Q, dv):
    x, cb = _inputs(B * N + Q, (B, N), hq, Q, dv)
    idx_j, xq_j = jax_vq_assign_batched(jnp.asarray(x), jnp.asarray(cb), block_n=8)
    idx_p, xq_p = vq_assign_batched(torch.tensor(x), torch.tensor(cb))
    np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(xq_p.numpy(), np.asarray(xq_j), atol=1e-6, rtol=0)
    for b in range(B):  # slice b equals the unbatched call on document b
        idx_s, xq_s = vq_assign(torch.tensor(x[b]), torch.tensor(cb))
        assert torch.equal(idx_s, idx_p[b]) and torch.equal(xq_s, xq_p[b])


def test_vq_assign_ref_matches_jax_ref_and_is_a_gather():
    x, cb = _inputs(5, (3, 11), 2, 64, 128)
    xh = x.reshape(33, 2, 128)
    idx_j, xq_j = jax_vq_assign_ref(jnp.asarray(xh), jnp.asarray(cb))
    idx_p, xq_p = vq_assign_ref(torch.tensor(xh), torch.tensor(cb))
    np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(xq_p.numpy(), np.asarray(xq_j), atol=1e-6, rtol=0)
    # x_q is the codebook row itself, bitwise
    want = cb[np.arange(2)[None, :], idx_p.numpy()]
    np.testing.assert_array_equal(xq_p.numpy(), want)
    # leading axes pass through: [3, 11, hq, dv] gives [3, 11, hq]
    idx_l, _ = vq_assign_ref(torch.tensor(x.reshape(3, 11, 2, 128)), torch.tensor(cb))
    assert torch.equal(idx_l.reshape(33, 2), idx_p)


def test_first_maximum_on_ties():
    """Two equal codes: the lower index wins, as jnp.argmax picks it."""
    cb = np.zeros((1, 4, 2), np.float32)
    cb[0, 1] = cb[0, 3] = [1.0, 0.0]
    x = np.array([[1.0, 0.0]], np.float32)
    idx_p, _ = vq_assign(torch.tensor(x), torch.tensor(cb))
    idx_j, _ = jax_vq_assign_ref(jnp.asarray(x.reshape(1, 1, 2)), jnp.asarray(cb))
    assert int(idx_p[0, 0]) == int(idx_j[0, 0]) == 1


def test_core_vq_matches_reference_module():
    x, cb = _inputs(9, (2, 17), 2, 64, 128)
    jp = ref_vq.VQParams(codebook=jnp.asarray(cb))
    pp = {"codebook": torch.tensor(cb)}
    xt = torch.tensor(x)
    np.testing.assert_allclose(port_vq.scores(pp, xt).numpy(),
                               np.asarray(ref_vq.scores(jp, jnp.asarray(x))),
                               atol=2e-5, rtol=1e-6)
    idx = port_vq.assign(pp, xt)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_vq.assign(jp, jnp.asarray(x))))
    np.testing.assert_array_equal(port_vq.lookup(pp, idx).numpy(),
                                  np.asarray(ref_vq.lookup(jp, jnp.asarray(idx.numpy()))))
    xq_p, idx_p = port_vq.quantize(pp, xt)
    xq_j, idx_j = ref_vq.quantize(jp, jnp.asarray(x))
    np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(xq_p.numpy(), np.asarray(xq_j), atol=1e-6, rtol=0)


def test_cpu_calls_do_not_count_and_bias_matches_numpy():
    x, cb = _inputs(1, (4,), 2, 8, 4)
    before = dict(LAUNCHES)
    vq_assign(torch.tensor(x), torch.tensor(cb))
    assert LAUNCHES == before  # the plain version is not a kernel launch
    # the plain version's bias (the CUDA kernel sums its own) matches numpy
    np.testing.assert_array_equal(codebook_bias(torch.tensor(cb)).numpy(),
                                  -0.5 * np.sum(cb.astype(np.float32) ** 2, axis=-1))


def test_kernel_schedule_rule_has_one_crossover():
    """The CUDA kernel's schedule is a fixed rule on the token count: a
    decode step runs the small schedule, the forward's [4, 1024] the
    32-token tile, and each schedule takes one range of token counts, in
    the order of ``SCHEDULES`` (one crossover between each two)."""
    from repro_torch.kernels.vq_assign import ops

    assert ops.schedule(1) == "small" and ops.schedule(4096) == "large32"
    order = [ops.SCHEDULES.index(ops.schedule(t)) for t in range(1, 4097)]
    assert order == sorted(order) and set(order) == set(range(len(ops.SCHEDULES)))
