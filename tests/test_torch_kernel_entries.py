"""The port's single-document ``fused_patch_assign`` and ``bucket_capacity``
against the reference's (``repro/kernels/fused_step/ops.py:25``,
``repro/kernels/incr_patch/ops.py:22``). On CPU tensors the wrapper runs
the plain version and launches nothing; it is the batched kernel's B = 1
view, which ``chip_smoke.py`` holds bitwise against a B = 1 batched launch
on the card."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.fused_step.ops import fused_patch_assign as ref_fused  # noqa: E402
from repro.kernels.incr_patch.ops import bucket_capacity as ref_capacity  # noqa: E402
from repro_torch.kernels.fused_step import (  # noqa: E402
    LAUNCHES, fused_patch_assign, fused_patch_assign_batched,
)
from repro_torch.kernels.incr_patch.ops import bucket_capacity  # noqa: E402


def _inputs(n, H, dh, C, Q, hq, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k_new, k_old = f(n, H, dh), f(H, C, dh), f(H, C, dh)
    vc_new, vc_old = f(H, C, Q), f(H, C, Q)
    mask = rng.random((n, C)) < 0.6
    mask[::5] = False  # fully masked rows keep T_base
    T_base = f(n, H, Q)
    counts = rng.integers(1, n + 1, n).astype(np.float32)
    vq_bias = f(hq, Q)
    return q, k_new, k_old, vc_new, vc_old, mask, T_base, counts, vq_bias


@pytest.mark.parametrize("n,H,dh,C,Q,hq", [
    (64, 4, 64, 8, 64, 2),    # the served head dim and codebook
    (37, 12, 64, 13, 64, 2),  # VQ-OPT's 12 heads, odd rows and columns
    (9, 2, 8, 3, 16, 1),      # hq = 1
])
def test_fused_patch_assign_matches_reference(n, H, dh, C, Q, hq):
    args = _inputs(n, H, dh, C, Q, hq, seed=n + C)
    T_r, codes_r = ref_fused(*map(jnp.asarray, args), heads_per_vq=H // hq)
    before = dict(LAUNCHES)
    T, codes = fused_patch_assign(*map(torch.from_numpy, args), heads_per_vq=H // hq)
    assert LAUNCHES == before  # the plain version: nothing launched
    assert T.shape == (n, H, Q) and T.dtype == torch.float32
    assert codes.shape == (n, hq) and codes.dtype == torch.int32
    np.testing.assert_allclose(T.numpy(), np.asarray(T_r), atol=2e-5, rtol=0)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_r))
    dead = ~args[5].any(-1)
    assert torch.equal(T[dead], torch.from_numpy(args[6][dead]))
    # the B = 1 view of the batched entry, bit for bit
    batched = [torch.from_numpy(a)[None] for a in args[:8]]
    batched[5] = batched[5].float()
    T_b, codes_b = fused_patch_assign_batched(*batched, torch.from_numpy(args[8]),
                                              heads_per_vq=H // hq)
    assert torch.equal(T, T_b[0]) and torch.equal(codes, codes_b[0])


def test_bucket_capacity_equals_reference():
    for minimum in (1, 8, 64):
        got = [bucket_capacity(n, minimum) for n in range(4097)]
        assert got == [ref_capacity(n, minimum) for n in range(4097)]
    assert [bucket_capacity(n) for n in (0, 8, 9, 4096)] == [8, 8, 16, 4096]
