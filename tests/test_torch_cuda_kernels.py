"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. This file imports neither jax nor the reference package, so it
also runs on a machine without JAX (the repo's conftest imports jax, so
run it there without it):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Elsewhere every test skips: a CUDA kernel has no CPU mode."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.fused_step import (  # noqa: E402
    LAUNCHES, delta_gate, delta_gate_ref, fused_patch_assign_batched,
    fused_patch_assign_ref,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, B, n, H, C, hq, seed=0, dh=64, Q=64):
    gen = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    mask = (torch.rand((B, n, C), generator=gen, device=dev) < 0.6).float()
    counts = torch.randint(1, n + 1, (B, n), generator=gen, device=dev).float()
    return [randn(B, n, H, dh), randn(B, H, C, dh), randn(B, H, C, dh),
            randn(B, H, C, Q), randn(B, H, C, Q), mask, randn(B, n, H, Q),
            counts, randn(hq, Q)]


@pytest.mark.parametrize("B,n,H,C,hq", [(4, 1024, 12, 72, 2),  # full width, deep layer
                                        (3, 37, 4, 5, 2),      # smoke heads, odd n and C
                                        (1, 1, 12, 33, 1),     # one row, g = 12
                                        (2, 100, 6, 64, 3)])   # C = 2 column tiles
def test_fused_step_kernel_matches_plain(dev, B, n, H, C, hq):
    args = _inputs(dev, B, n, H, C, hq, seed=n + C)
    args[5][0, :: 3] = 0.0  # fully masked rows
    before = LAUNCHES["fused_step"]
    T_k, codes_k = fused_patch_assign_batched(*args, heads_per_vq=H // hq)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_step"] == before + 1
    T_p, codes_p = fused_patch_assign_ref(*args)
    torch.testing.assert_close(T_k, T_p, atol=1e-4, rtol=1e-5)
    dead = args[5].sum(-1) == 0
    assert torch.equal(T_k[dead], args[6][dead])  # bitwise T_base
    g = H // hq
    s = T_p.reshape(B, n, hq, g, -1).sum(3) / args[7][..., None, None] + args[8]
    top2 = s.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= 1e-5
    assert not ((codes_k != codes_p) & ~near).any()


@pytest.mark.parametrize("r,d", [(64, 768), (1024, 768), (3, 5)])
def test_delta_gate_kernel_bitwise_equals_plain(dev, r, d):
    gen = torch.Generator(device=dev).manual_seed(r)
    x_old = torch.randn((r, d), generator=gen, device=dev)
    x_new = x_old + (torch.rand((r, d), generator=gen, device=dev) * 2 - 1) * 1.2
    x_new[0] = x_old[0]
    x_old[0, 0], x_new[0, 0] = 2.5, 3.5  # change exactly the threshold
    before = LAUNCHES["delta_gate"]
    keep = delta_gate(x_new, x_old, 1.0)
    assert LAUNCHES["delta_gate"] == before + 1
    assert torch.equal(keep, delta_gate_ref(x_new, x_old, 1.0))
    assert not keep[0]


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    args = _inputs(dev, 1, 8, 4, 3, 2, dh=16, Q=16)
    with pytest.raises(ValueError, match="dh=Q=64"):
        fused_patch_assign_batched(*args, heads_per_vq=2)
    args = _inputs(dev, 2, 8, 4, 3, 2)
    q_strided = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_patch_assign_batched(q_strided, *args[1:], heads_per_vq=2)
    with pytest.raises(ValueError, match="float32"):
        fused_patch_assign_batched(args[0].double(), *args[1:], heads_per_vq=2)
    with pytest.raises(ValueError, match="float32"):
        delta_gate(args[0][0, 0].double(), args[0][0, 0].double(), 1.0)
