"""The port's fused edit-step kernels module against the reference.

On the CPU the wrappers run the plain PyTorch versions (``ref.py``); those
are held against the reference's Pallas kernel (interpret mode) and its
plain jnp version on the same numpy inputs. The hand-written CUDA kernels
are held against the plain versions on the card by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``."""
import pytest

torch = pytest.importorskip("torch")

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.fused_step import fused_patch_assign as ref_fused  # noqa: E402
from repro.kernels.fused_step.fused_step import delta_gate_kernel as ref_gate_kernel  # noqa: E402
from repro.kernels.fused_step import fused_patch_assign_ref as ref_plain  # noqa: E402
from repro.kernels.fused_step.ref import delta_gate_ref as ref_gate  # noqa: E402
from repro_torch.kernels.fused_step import (  # noqa: E402
    LAUNCHES, delta_gate, delta_gate_ref, fused_patch_assign_batched,
    fused_patch_assign_ref,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def _inputs(n, H, dh, C, Q, hq, seed=0, mask_p=0.6, batch=None):
    rng = np.random.default_rng(seed)
    shape = (lambda *s: ((batch,) + s) if batch else s)
    f = lambda *s: rng.standard_normal(shape(*s)).astype(np.float32)
    q, k_new, k_old = f(n, H, dh), f(H, C, dh), f(H, C, dh)
    vc_new, vc_old = f(H, C, Q), f(H, C, Q)
    mask = (rng.random(shape(n, C)) < mask_p).astype(np.float32)
    T_base = f(n, H, Q)
    counts = rng.integers(1, n + 1, shape(n)).astype(np.float32)
    vq_bias = rng.standard_normal((hq, Q)).astype(np.float32)
    return q, k_new, k_old, vc_new, vc_old, mask, T_base, counts, vq_bias


def _torch(args):
    return [torch.from_numpy(a) for a in args]


@pytest.mark.parametrize(
    "n,H,dh,C,Q,hq,block_r",
    [
        (64, 4, 64, 8, 64, 2, 32),     # pow2 everything
        (13, 4, 8, 5, 16, 2, 8),       # odd rows/columns, tiny dims
        (100, 6, 16, 7, 48, 3, 128),   # non-pow2, block_r > n (one block)
        (7, 2, 4, 3, 8, 1, 4),         # hq=1 (every head in one vq group)
    ],
)
def test_plain_fused_step_matches_reference(n, H, dh, C, Q, hq, block_r):
    args = _inputs(n, H, dh, C, Q, hq, seed=n + C)
    T_k, codes_k = ref_fused(*map(jnp.asarray, args), heads_per_vq=H // hq,
                             block_r=block_r)
    T_r, codes_r = ref_plain(*map(jnp.asarray, args))
    T_p, codes_p = fused_patch_assign_ref(*_torch(args))
    assert T_p.shape == (n, H, Q) and codes_p.shape == (n, hq)
    assert T_p.dtype == torch.float32 and codes_p.dtype == torch.int32
    for T_ref, codes_ref in ((T_k, codes_k), (T_r, codes_r)):
        np.testing.assert_allclose(T_p.numpy(), np.asarray(T_ref),
                                   atol=2e-5, rtol=1e-5)
        np.testing.assert_array_equal(codes_p.numpy(), np.asarray(codes_ref))


def test_masked_rows_and_masked_document_keep_T_base():
    """A fully masked row gets an exactly-zero patch (T is T_base bitwise);
    a fully masked document in a batch — a dispatch's filler row — keeps
    T_base everywhere. Through the batched wrapper, which on CPU tensors
    runs the plain version and launches nothing."""
    B, n, H, dh, C, Q, hq = 3, 11, 4, 64, 6, 64, 2
    args = list(_inputs(n, H, dh, C, Q, hq, seed=3, batch=B))
    mask = args[5]
    mask[0, 2] = 0.0
    mask[0, 7] = 0.0
    mask[1] = 0.0
    before = dict(LAUNCHES)
    T_all, codes = fused_patch_assign_batched(*_torch(args), heads_per_vq=H // hq)
    assert LAUNCHES == before
    T_base = args[6]
    for r in (2, 7):
        np.testing.assert_array_equal(T_all[0, r].numpy(), T_base[0, r])
    np.testing.assert_array_equal(T_all[1].numpy(), T_base[1])
    # slice b of the batched call equals the unbatched plain version
    for b in range(B):
        per = [torch.from_numpy(a[b]) for a in args[:-1]] + [torch.from_numpy(args[-1])]
        T_b, codes_b = fused_patch_assign_ref(*per)
        np.testing.assert_array_equal(codes[b].numpy(), codes_b.numpy())
        np.testing.assert_allclose(T_all[b].numpy(), T_b.numpy(), atol=1e-6)


@pytest.mark.parametrize("r,d,threshold", [(64, 768, 1.0), (1024, 768, 1.0),
                                           (37, 5, 0.25)])
def test_plain_delta_gate_bitwise_equals_reference(r, d, threshold):
    rng = np.random.default_rng(r + d)
    x_old = rng.standard_normal((r, d)).astype(np.float32)
    x_new = (x_old + rng.uniform(-1.5, 1.5, (r, d)) * threshold).astype(np.float32)
    # rows whose largest change is EXACTLY the threshold (strict > drops them)
    x_old[:4] = 2.5
    x_new[:4] = 2.5
    x_new[:4, 0] = 2.5 + threshold
    x_new[4] = x_old[4]  # an unchanged row
    keep = delta_gate(torch.from_numpy(x_new), torch.from_numpy(x_old), threshold)
    ref = np.asarray(ref_gate(jnp.asarray(x_new), jnp.asarray(x_old), threshold))
    assert keep.dtype == torch.bool and keep.shape == (r,)
    np.testing.assert_array_equal(keep.numpy(), ref)
    assert not keep[:5].any()
    np.testing.assert_array_equal(
        delta_gate_ref(torch.from_numpy(x_new), torch.from_numpy(x_old),
                       threshold).numpy(), ref)


@pytest.mark.parametrize("r,d,threshold,block_r", [
    (64, 768, 1.0, 128),
    (64, 768, 0.1, 16),    # 0.1 is not an f32: the compare must be in f32
    (37, 5, 0.1, 8),       # ragged rows (padding in the Pallas grid)
    (20, 770, 0.25, 8),
])
def test_plain_delta_gate_edge_rows_equal_reference_and_pallas(r, d, threshold, block_r):
    """NaN, +inf against +inf, -0.0 against 0.0, a change of exactly the
    threshold and one ulp above it (``chip_smoke.gate_edge_rows``, the rows
    the card checks): the port's plain gate equals the reference's jnp
    oracle and its Pallas kernel in interpret mode bit for bit."""
    rng = np.random.default_rng(r + d)
    x_old = torch.from_numpy(rng.standard_normal((r, d)).astype(np.float32))
    x_new = x_old + torch.from_numpy(
        rng.uniform(-1.5, 1.5, (r, d)).astype(np.float32)) * threshold
    edge = cs.gate_edge_rows(x_new, x_old, threshold)
    before = dict(LAUNCHES)
    keep = delta_gate(x_new, x_old, threshold)
    assert LAUNCHES == before  # a CPU tensor runs the plain version
    xn, xo = jnp.asarray(x_new.numpy()), jnp.asarray(x_old.numpy())
    for want in (ref_gate(xn, xo, threshold),
                 ref_gate_kernel(xn, xo, threshold=threshold, block_r=block_r,
                                 interpret=True)):
        np.testing.assert_array_equal(keep.numpy(), np.asarray(want))
    assert keep[:len(edge)].tolist() == edge
