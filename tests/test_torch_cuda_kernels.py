"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. This file imports neither jax nor the reference package, so it
also runs on a machine without JAX (the repo's conftest imports jax, so
run it there without it):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Elsewhere every test skips: a CUDA kernel has no CPU mode."""
import sys
from pathlib import Path
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import gated_attention as ga  # noqa: E402
from repro_torch.kernels import incr_patch as ip  # noqa: E402
from repro_torch.kernels import vq_assign as vq  # noqa: E402
from repro_torch.kernels.fused_step import (  # noqa: E402
    LAUNCHES, delta_gate, delta_gate_ref, fused_patch_assign_batched,
    fused_patch_assign_ref,
)
from repro_torch.kernels.fused_step import ops as fs_ops  # noqa: E402
from repro_torch.kernels.fused_step.ops import GATE_SHAPES  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

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


def _engine_mask(dev, B, n, C, seed):
    """The patch mask as the engine's fused step builds it: column c is the
    sorted slot ``col[c]``, live where its position id is at most the row's
    (causal order), times row validity, times not dirty (the first C - 8
    columns are changed rows). Sorted positions zero whole tiles above the
    diagonal. The last document is a filler: all zero."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    mask = torch.zeros((B, n, C), device=dev)
    for b in range(B - 1):
        length = min((256, 300, 700, 1000)[b % 4], n)
        pos = torch.randperm(4 * n, generator=gen, device=dev)[:n].sort().values
        col = torch.randperm(length, generator=gen, device=dev)[:C].sort().values
        row_valid = (torch.arange(n, device=dev) < length).float()
        dirty = torch.zeros(n, device=dev)
        dirty[col[:C - 8]] = 1.0
        mask[b] = ((pos[col][None, :] <= pos[:, None]).float()
                   * (row_valid * (1.0 - dirty))[:, None])
    return mask


TIE = (5, 40)  # two codes owned by different threads of a row


@pytest.mark.parametrize("B,n,H,C,hq,case", [
    (4, 1024, 12, 8, 2, "random"),    # full width, layer 0 (C = 8)
    (4, 1024, 12, 72, 2, "random"),   # full width, R = 64
    (4, 1024, 12, 136, 2, "random"),  # full width, R = 128
    (4, 1024, 12, 264, 2, "random"),  # full width, R = 256 (after overflows)
    (1, 1024, 12, 72, 2, "random"),   # the single-document grid
    (4, 1024, 12, 72, 2, "causal"),   # the engine's mask: whole dead tiles
    (2, 1000, 12, 72, 2, "random"),   # n not a multiple of the row tile
    (3, 37, 4, 5, 2, "random"),       # smoke heads, odd n and C
    (1, 1, 12, 33, 1, "random"),      # one row, g = 12, C = 33
    (2, 100, 6, 64, 3, "random"),     # C = 2 column tiles, g = 2
    (2, 200, 12, 1, 12, "random"),    # C = 1, g = 1
    (2, 130, 12, 31, 1, "random"),    # C = 31, g = 12
    (1, 1024, 12, 72, 1, "random"),   # g = 12 at full n
    (2, 300, 12, 72, 2, "tie"),       # an exact tie across threads
])
def test_fused_step_kernel_matches_plain(dev, B, n, H, C, hq, case):
    args = _inputs(dev, B, n, H, C, hq, seed=n + C)
    if case == "causal":
        args[5] = _engine_mask(dev, B, n, C, seed=n + C)
    args[5][0, :: 3] = 0.0  # fully masked rows
    args[6][:, ::5, :, :3] = -0.0  # a dead row keeps the sign of -0.0
    if case == "tie":
        lo, hi = TIE
        for a in (args[3], args[4], args[6]):  # vc_new, vc_old, T_base
            a[..., hi] = a[..., lo]
        args[6][..., lo] = args[6][..., hi] = 100.0  # the row maximum,
        args[8][:, lo] = args[8][:, hi] = 50.0  # whatever the row's count
    before = LAUNCHES["fused_step"]
    T_k, codes_k = fused_patch_assign_batched(*args, heads_per_vq=H // hq)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_step"] == before + 1
    T_p, codes_p = fused_patch_assign_ref(*args)
    # the reference's own f32 bound (tests/test_fused_step.py)
    torch.testing.assert_close(T_k, T_p, atol=2e-5, rtol=1e-5)
    dead = args[5].sum(-1) == 0
    assert bool(dead.any())
    # bitwise T_base (torch.equal does not tell -0.0 from +0.0)
    assert torch.equal(T_k[dead].view(torch.int32), args[6][dead].view(torch.int32))
    g = H // hq
    s = T_p.reshape(B, n, hq, g, -1).sum(3) / args[7][..., None, None] + args[8]
    top2 = s.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= 1e-5
    assert not ((codes_k != codes_p) & ~near).any()
    if case == "tie":
        assert (codes_k == TIE[0]).all()  # the first maximum


def test_fused_step_on_two_streams_at_once(dev):
    """Launches on two streams of one device run at the same time and keep
    their own arrival counts: each gives the plain version's T and codes."""
    from repro_torch.kernels import _launch

    cases = [_inputs(dev, 4, 1024, 12, 72, 2, seed=s) for s in (1, 2)]
    want = [fused_patch_assign_ref(*a) for a in cases]
    streams = [torch.cuda.Stream(dev) for _ in cases]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(8):  # the two streams' launches interleave on the card
        for k, (a, st) in enumerate(zip(cases, streams)):
            with torch.cuda.stream(st):
                got[k].append(fused_patch_assign_batched(*a, heads_per_vq=6))
    torch.cuda.synchronize()
    assert {st.cuda_stream for st in streams} <= {s_ for _, s_ in _launch._COUNTS}
    for (T_p, codes_p), runs, a in zip(want, got, cases):
        s = T_p.reshape(4, 1024, 2, 6, -1).sum(3) / a[7][..., None, None] + a[8]
        top2 = s.topk(2, dim=-1).values
        near = (top2[..., 0] - top2[..., 1]) <= 1e-5
        for T_k, codes_k in runs:
            torch.testing.assert_close(T_k, T_p, atol=2e-5, rtol=1e-5)
            assert not ((codes_k != codes_p) & ~near).any()
            assert torch.equal(codes_k, runs[0][1])


def _gate_rows(dev, r, d, threshold, offset=0):
    """Random [r, d] rows (a change of up to 1.2 x the threshold) with the
    edge rows of ``chip_smoke.gate_edge_rows``; with ``offset``, views that
    start ``offset`` floats into their storage (not 16-byte aligned)."""
    gen = torch.Generator(device=dev).manual_seed(r + d)
    x_old = torch.randn((r * d + offset,), generator=gen, device=dev)[offset:].view(r, d)
    x_new = torch.empty((r * d + offset,), device=dev)[offset:].view(r, d)
    x_new.copy_(x_old + (torch.rand((r, d), generator=gen, device=dev) * 2 - 1)
                * 1.2 * threshold)
    return x_new, x_old, cs.gate_edge_rows(x_new, x_old, threshold)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("threshold", [1.0, 0.1])
@pytest.mark.parametrize("r,d", [(r, 768) for r in (64, 128, 256, 512, 1024, 2048)]
                         + [(37, 5), (300, 770)])
def test_delta_gate_kernel_bitwise_equals_plain(dev, r, d, threshold, offset):
    """Keep bits equal the plain version's at every served r (d=768), on the
    scalar path (d = 5, 770; an unaligned base) and at the edge rows: NaN,
    +inf against +inf, -0.0 against 0.0, a change of exactly the threshold
    (0.1 is not an f32) and one ulp above it."""
    x_new, x_old, edge = _gate_rows(dev, r, d, threshold, offset)
    assert (x_new.data_ptr() % 16 != 0) == bool(offset)
    before = LAUNCHES["delta_gate"]
    keep = delta_gate(x_new, x_old, threshold)
    assert LAUNCHES["delta_gate"] == before + 1
    assert torch.equal(keep, delta_gate_ref(x_new, x_old, threshold))
    assert keep[:len(edge)].tolist() == edge


@pytest.mark.parametrize("shape", GATE_SHAPES)
@pytest.mark.parametrize("r,d", [(300, 768), (37, 5), (9, 4096), (9, 8)])
def test_delta_gate_every_launch_shape_gives_the_same_bits(dev, r, d, shape):
    """Each (rows a CTA, burst or stream) the sweep forces gives the plain
    version's bits, also where a row takes several passes (d=4096) or a
    CTA's last rows run past r."""
    x_new, x_old, edge = _gate_rows(dev, r, d, 1.0)
    with mock.patch.object(fs_ops, "gate_shape", lambda _r: shape):
        keep = delta_gate(x_new, x_old, 1.0)
    assert torch.equal(keep, delta_gate_ref(x_new, x_old, 1.0))
    assert keep[:len(edge)].tolist() == edge


def test_delta_gate_refuses_a_launch_shape_the_kernel_does_not_take(dev):
    x = torch.zeros((4, 768), device=dev)
    for shape in ((0, True), (9, False), (16, True)):
        with mock.patch.object(fs_ops, "gate_shape", lambda _r, _s=shape: _s):
            with pytest.raises(RuntimeError, match="delta_gate kernel launch failed"):
                delta_gate(x, x, 1.0)


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
    q_off = torch.empty(args[0].numel() + 1, device=dev)[1:].view(args[0].shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_patch_assign_batched(q_off.copy_(args[0]), *args[1:], heads_per_vq=2)
    with pytest.raises(ValueError, match="float32"):
        delta_gate(args[0][0, 0].double(), args[0][0, 0].double(), 1.0)


def _vq_check(x, cb, idx, xq, near):
    """Indices equal the plain version's away from near-ties (the dot
    products sum in another order); x_q bitwise the codebook row."""
    N, hq = idx.shape
    idx_p, _ = vq.vq_assign_ref(x.reshape(N, hq, -1), cb)
    assert not ((idx != idx_p) & ~near).any()
    heads = torch.arange(hq, device=x.device)
    assert torch.equal(xq.reshape(N, hq, -1), cb[heads, idx.long()])


@pytest.mark.parametrize("dv", [24, 30, 128, 384, 800, 1536, 2048, 8192])  # 30: the scalar path
@pytest.mark.parametrize("Q", [48, 64, 256])
@pytest.mark.parametrize("N", [1, 37, 1024])
def test_vq_assign_kernel_matches_plain(dev, monkeypatch, dv, Q, N, hq=2):
    gen = torch.Generator(device=dev).manual_seed(N + Q + dv)
    x = torch.randn((N, hq * dv), generator=gen, device=dev)
    cb = torch.randn((hq, Q, dv), generator=gen, device=dev) * 0.5
    lo, hi = 3, Q - 2  # equal codebook rows, in other warps, lanes and code tiles
    cb[:, hi] = cb[:, lo]
    x[0] = cb[:, lo].reshape(-1)  # token 0 sits on code lo (and hi): an exact tie
    s = torch.einsum("nhd,hqd->nhq", x.reshape(N, hq, dv), cb) + vq.codebook_bias(cb)
    top2 = s.topk(2, dim=-1).values
    # top-two scores within 1e-4, or within two float32 ulps of the score
    # where that is coarser (|score| above ~420: dv = 8192's scores sit near
    # -1024, where one ulp is 1.2e-4 and two summation orders round apart)
    tie = torch.clamp(2 * torch.finfo(torch.float32).eps * top2[..., 0].abs(), min=1e-4)
    near = (top2[..., 0] - top2[..., 1]) <= tie
    before = vq.LAUNCHES["vq_assign"]
    idx, xq = vq.vq_assign(x, cb)  # the schedule the rule picks
    torch.cuda.synchronize()
    assert vq.LAUNCHES["vq_assign"] == before + 1
    _vq_check(x, cb, idx, xq, near)
    assert (idx[0] == lo).all()
    # an unaligned codebook (same values) runs the scalar path
    cb_off = torch.empty(cb.numel() + 1, device=dev)[1:].view(cb.shape).copy_(cb)
    idx_u, xq_u = vq.vq_assign(x, cb_off)
    _vq_check(x, cb, idx_u, xq_u, near)
    assert (idx_u[0] == lo).all()
    for name in vq.ops.SCHEDULES:  # each schedule and tile, on both sides of the crossovers
        monkeypatch.setattr(vq.ops, "schedule", lambda _tokens, _n=name: _n)
        before = vq.LAUNCHES["vq_assign"]
        idx_s, xq_s = vq.vq_assign(x, cb)
        idx_b, xq_b = vq.vq_assign_batched(x.reshape(1, N, -1).repeat(3, 1, 1), cb)
        torch.cuda.synchronize()
        assert vq.LAUNCHES["vq_assign"] == before + 2
        _vq_check(x, cb, idx_s, xq_s, near)
        assert (idx_s[0] == lo).all()
        # B > 1: one schedule and tile sums a token's scores in one order,
        # whatever batch it is quantized in: each document equals the unbatched call
        assert torch.equal(idx_b, idx_s[None].repeat(3, 1, 1))
        assert torch.equal(xq_b, xq_s[None].repeat(3, 1, 1))


def _qkv(dev, BH, nq, nk, amp=1.0, seed=None, dh=64):
    gen = torch.Generator(device=dev).manual_seed(nq + nk if seed is None else seed)
    q = torch.randn((BH, nq, dh), generator=gen, device=dev) * 0.5 * amp
    k = torch.randn((BH, nk, dh), generator=gen, device=dev) * 0.5 * amp
    v = torch.randn((BH, nk, dh), generator=gen, device=dev)
    return q, k, v


@pytest.mark.parametrize("BH,nq,nk,amp", [
    (48, 1024, 1024, 1), (48, 1000, 1000, 1), (48, 37, 37, 1),
    (5, 100, 70, 1), (5, 70, 100, 1), (3, 1, 1, 1),
    (48, 2048, 2048, 1),  # the longest full_attention sends the kernel
    (12, 1024, 1024, 1),  # one document of 12 heads
    (96, 1024, 1024, 1),  # the VQ-OPT-125M train step's [8, 1024] batch
    (4, 65, 65, 1),       # one row past a 64-row tile
    (4, 16, 16, 1),       # one warp's 16 rows
    (4, 1024, 512, 1),    # nq > nk: rows past nk attend every key
    (4, 512, 1024, 1),    # nq < nk
    (8, 300, 300, 3),     # |s| up to ~10: the split's error and the GELU's tail
    (25, 4096, 4096, 1), (25, 1000, 1000, 1),  # hymba's global layers (25 heads)
])
def test_gated_attention_kernel_matches_plain(dev, BH, nq, nk, amp):
    q, k, v = _qkv(dev, BH, nq, nk, amp)
    before = ga.LAUNCHES["gated_attention"]
    out = ga.gated_attention_bh(q, k, v)
    torch.cuda.synchronize()
    assert ga.LAUNCHES["gated_attention"] == before + 1
    torch.testing.assert_close(out, ga.gated_attention_ref(q, k, v), atol=1e-5, rtol=1e-5)


def test_gated_attention_writes_no_row_past_nq(dev):
    """The launcher into a buffer longer than [BH, nq, 64]: the rows past
    nq (the last q tile is part padding) stay as they were."""
    from repro_torch.kernels._launch import bind, stream_of

    BH, nq, nk = 3, 100, 100
    q, k, v = _qkv(dev, BH, nq, nk)
    buf = torch.full(((BH * nq + 64) * 64,), 7.0, device=dev)
    fn = bind("gated_attention", "gated_attention_launch", ga.ops.ARGTYPES)
    assert fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), buf.data_ptr(), BH, nq, nk, 64,
              0.125, stream_of(dev)) == 0
    torch.cuda.synchronize()
    out = buf[:BH * nq * 64].view(BH, nq, 64)
    torch.testing.assert_close(out, ga.gated_attention_ref(q, k, v), atol=1e-5, rtol=1e-5)
    assert (buf[BH * nq * 64:] == 7.0).all()


def test_gated_attention_two_calls_are_bitwise_equal(dev):
    """No atomics and a fixed order of every sum: the same bits each call."""
    q, k, v = _qkv(dev, 48, 1000, 1000, seed=5)
    a = ga.gated_attention_bh(q, k, v)
    b = ga.gated_attention_bh(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("BH,nq,nk,dh,amp", [
    (24, 4096, 4096, 128, 1),  # phi4-mini's forward (24 heads, one document)
    (16, 3072, 3072, 256, 1),  # gemma3's global layer
    (24, 1000, 1000, 128, 1), (16, 1000, 1000, 256, 1),  # ragged tiles
    (5, 100, 70, 128, 1), (5, 70, 100, 256, 1), (3, 1, 1, 128, 1), (3, 1, 1, 256, 1),
    (4, 65, 65, 256, 1), (4, 33, 33, 128, 1),  # one row / key past a tile
    (8, 300, 300, 128, 3), (8, 300, 300, 256, 3),  # |s| up to ~14
])
def test_gated_attention_wide_heads_match_plain(dev, BH, nq, nk, dh, amp):
    q, k, v = _qkv(dev, BH, nq, nk, amp, dh=dh)
    before = ga.LAUNCHES["gated_attention"]
    out = ga.gated_attention_bh(q, k, v)
    torch.cuda.synchronize()
    assert ga.LAUNCHES["gated_attention"] == before + 1
    torch.testing.assert_close(out, ga.gated_attention_ref(q, k, v), atol=1e-5, rtol=1e-5)
    again = ga.gated_attention_bh(q, k, v)  # a fixed order of every sum
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))


@pytest.mark.parametrize("dh", [128, 256])
def test_gated_attention_wide_heads_write_no_row_past_nq(dev, dh):
    from repro_torch.kernels._launch import bind, stream_of

    BH, nq, nk = 3, 100, 100
    q, k, v = _qkv(dev, BH, nq, nk, dh=dh)
    buf = torch.full(((BH * nq + 64) * dh,), 7.0, device=dev)
    fn = bind("gated_attention", "gated_attention_launch", ga.ops.ARGTYPES)
    assert fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), buf.data_ptr(), BH, nq, nk, dh,
              dh ** -0.5, stream_of(dev)) == 0
    torch.cuda.synchronize()
    out = buf[:BH * nq * dh].view(BH, nq, dh)
    torch.testing.assert_close(out, ga.gated_attention_ref(q, k, v), atol=1e-5, rtol=1e-5)
    assert (buf[BH * nq * dh:] == 7.0).all()


def test_gated_attention_other_head_dims_raise(dev):
    """dh = 80 (h2o-danube's heads) has no instantiation: the wrapper raises
    on the card and names the dims it takes; the launcher refuses it too."""
    from repro_torch.kernels._launch import bind, stream_of

    q, k, v = _qkv(dev, 2, 16, 16, dh=80)
    with pytest.raises(ValueError, match=r"dh=dv in \(64, 128, 256\)"):
        ga.gated_attention_bh(q, k, v)
    fn = bind("gated_attention", "gated_attention_launch", ga.ops.ARGTYPES)
    out = torch.empty_like(q)
    assert fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 2, 16, 16, 80,
              80 ** -0.5, stream_of(dev)) != 0
    x = torch.zeros((2, 16, 128), device=dev)
    with pytest.raises(ValueError, match="dh=128 dv=64"):
        ga.gated_attention_bh(x, x, x[..., :64].contiguous())


def test_gated_attention_model_layout_gqa_wide(dev):
    """phi4-mini's layout at dh = 128: 24 query heads over 8 kv heads."""
    gen = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn((1, 300, 24, 128), generator=gen, device=dev) * 0.5
    k = torch.randn((1, 300, 8, 128), generator=gen, device=dev) * 0.5
    v = torch.randn((1, 300, 8, 128), generator=gen, device=dev)
    out = ga.gated_attention(q, k, v)
    fold = lambda a: a.repeat_interleave(24 // a.shape[2], 2).transpose(1, 2).reshape(24, 300, 128)
    want = ga.gated_attention_ref(fold(q), fold(k), fold(v))
    want = want.reshape(1, 24, 300, 128).transpose(1, 2).reshape(1, 300, 24 * 128)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)


def test_gated_attention_model_layout_gqa_hymba(dev):
    """hymba's layout: 25 query heads over 5 kv heads of 64 (BH = 25)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((1, 300, 25, 64), generator=gen, device=dev) * 0.5
    k = torch.randn((1, 300, 5, 64), generator=gen, device=dev) * 0.5
    v = torch.randn((1, 300, 5, 64), generator=gen, device=dev)
    before = ga.LAUNCHES["gated_attention"]
    out = ga.gated_attention(q, k, v)
    assert ga.LAUNCHES["gated_attention"] == before + 1
    fold = lambda a: a.repeat_interleave(25 // a.shape[2], 2).transpose(1, 2).reshape(25, 300, 64)
    want = ga.gated_attention_ref(fold(q), fold(k), fold(v))
    want = want.reshape(1, 25, 300, 64).transpose(1, 2).reshape(1, 300, 25 * 64)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)


def test_gated_attention_model_layout_gqa(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((2, 200, 8, 64), generator=gen, device=dev)
    k = torch.randn((2, 200, 4, 64), generator=gen, device=dev)
    v = torch.randn((2, 200, 4, 64), generator=gen, device=dev)
    out = ga.gated_attention(q, k, v)
    fold = lambda a: a.repeat_interleave(8 // a.shape[2], 2).transpose(1, 2).reshape(16, 200, 64)
    want = ga.gated_attention_ref(fold(q), fold(k), fold(v))
    want = want.reshape(2, 8, 200, 64).transpose(1, 2).reshape(2, 200, 512)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,R,C,case", [
    (4, 1024, 5, "random"),    # C not a multiple of the 32-column tile
    (4, 1024, 8, "random"),    # full width, layer 0
    (4, 1024, 72, "random"),
    (4, 1024, 264, "random"),
    (1, 1024, 8, "random"),    # a single document, as most served steps
    (1, 1024, 1032, "random"),  # the most served step
    (2, 1024, 136, "random"),
    (2, 1000, 72, "random"),   # R not a multiple of the 64-row tile
    (2, 1000, 100, "one_tile"),  # live columns in one column tile only
])
def test_incr_patch_kernel_matches_plain(dev, monkeypatch, B, R, C, case, H=12):
    gen = torch.Generator(device=dev).manual_seed(B * 10_000 + R + C)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    args = [randn(B, R, H, 64), randn(B, H, C, 64), randn(B, H, C, 64),
            randn(B, H, C, 64), randn(B, H, C, 64),
            (torch.rand((B, R, C), generator=gen, device=dev) < 0.4).float()]
    if case == "one_tile":  # every (row tile, column tile) pair but one is dead
        args[5][..., :64] = 0.0
        args[5][..., 96:] = 0.0
    if B > 1:
        args[5][B - 1] = 0.0  # an all-masked filler document
    row_valid = (torch.rand((B, R), generator=gen, device=dev) < 0.9).float()
    before = ip.LAUNCHES["incr_patch"]
    out = ip.incr_patch_batched(*args, row_valid=row_valid)
    one = ip.incr_patch(*(a[0].contiguous() for a in args), row_valid=row_valid[0])
    torch.cuda.synchronize()
    assert ip.LAUNCHES["incr_patch"] == before + 2
    mask = args[5] * row_valid[..., None]
    want = ip.incr_patch_ref(*args[:5], mask)
    torch.testing.assert_close(out, want, atol=1e-4, rtol=1e-5)
    assert torch.equal(out[0], one)
    dead = mask.sum(-1) == 0
    assert bool(dead.any()) and (out[dead] == 0).all()
    assert (out[row_valid == 0] == 0).all()
    if B > 1:
        assert (out[B - 1] == 0).all()
    if case == "one_tile":
        assert bool((out[0] != 0).any())
    for two in (False, True):  # one CTA a tile, or one a product: the same bits
        monkeypatch.setattr(ip.ops, "split", lambda *_a, _two=two: _two)
        out_s = ip.incr_patch_batched(*args, row_valid=row_valid)
        one_s = ip.incr_patch(*(a[0].contiguous() for a in args), row_valid=row_valid[0])
        torch.cuda.synchronize()
        assert torch.equal(out_s, out) and torch.equal(one_s, one)


def test_new_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros((4, 2, 32), device=dev)
    with pytest.raises(ValueError, match="dh=dv in"):
        ga.gated_attention_bh(x, x, x)
    q_off = torch.zeros((4 * 2 * 64 + 1,), device=dev)[1:].view(4, 2, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ga.gated_attention_bh(q_off, q_off.clone(), q_off.clone())
    with pytest.raises(ValueError, match="Q <= 256"):
        vq.vq_assign(torch.zeros((3, 8), device=dev), torch.zeros((2, 300, 4), device=dev))
    with pytest.raises(ValueError, match="dh=Q=64"):
        ip.incr_patch(torch.zeros((3, 2, 16), device=dev), *[torch.zeros((2, 4, 16), device=dev)] * 4,
                      torch.ones((3, 4), device=dev))


def _bwd_inputs(dev, BH, n, seed=None, amp=1.0, dh=64):
    q, k, v = _qkv(dev, BH, n, n, amp, seed=seed, dh=dh)
    gen = torch.Generator(device=dev).manual_seed(7 + n)
    return q, k, v, torch.randn((BH, n, dh), generator=gen, device=dev)


@pytest.mark.parametrize("BH,n,amp", [
    (96, 1024, 1), (48, 1024, 1), (48, 1000, 1), (48, 37, 1), (48, 1, 1),  # chip_smoke's
    (3, 64, 1),    # one tile
    (3, 65, 1),    # one row past a tile
    (3, 129, 1),   # three tiles, the last of one row
    (8, 300, 3),   # |s| up to ~10: the GELU's tail and its derivative's
    (3, 31, 1),    # one pass (32 rows) less a row
    (3, 32, 1),    # one pass
    (3, 33, 1),    # a pass and a row: the second pass of the diagonal tile
    (3, 97, 1),    # a tile and a pass and a row
    (5, 129, 3),   # two tiles and a row, the GELU's tail
])
def test_gated_attention_bwd_kernel_matches_plain(dev, BH, n, amp):
    """dq, dk and dv of the two backward kernels within chip_smoke's
    tolerance (1e-5 of the plain version's max |.|); one launch each."""
    q, k, v, do = _bwd_inputs(dev, BH, n, amp=amp)
    before = dict(ga.LAUNCHES)
    got = ga.gated_attention_bwd_bh(q, k, v, do)
    torch.cuda.synchronize()
    assert ga.LAUNCHES["gated_attention_bwd_dkv"] == before["gated_attention_bwd_dkv"] + 1
    assert ga.LAUNCHES["gated_attention_bwd_dq"] == before["gated_attention_bwd_dq"] + 1
    for g, w in zip(got, ga.gated_attention_bwd_ref(q, k, v, do)):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= cs.BWD_TOL * float(w.abs().max())


@pytest.mark.parametrize("BH,n,dh,amp", [
    (24, 1000, 128, 1), (16, 1000, 256, 1),  # phi4-mini's and gemma3's heads
    (24, 37, 128, 1), (16, 37, 256, 1), (24, 1, 128, 1), (16, 1, 256, 1),
    (3, 33, 128, 1), (3, 17, 256, 1),   # a streamed tile and a row
    (3, 65, 128, 1), (3, 129, 256, 1),  # a row past a tile
    (8, 300, 128, 3), (8, 300, 256, 3),  # |s| up to ~14: the GELU's tail
])
def test_gated_attention_bwd_wide_heads_match_plain(dev, BH, n, dh, amp):
    """dh = 128 and 256 (BH = heads of phi4-mini, 24, and of gemma3, 16,
    as the GQA wrapper hands them over): dq, dk and dv within 1e-5 of the
    plain version's max |.|, one launch of each kernel, the same bits on a
    second call."""
    q, k, v, do = _bwd_inputs(dev, BH, n, amp=amp, dh=dh)
    before = dict(ga.LAUNCHES)
    got = ga.gated_attention_bwd_bh(q, k, v, do)
    torch.cuda.synchronize()
    assert ga.LAUNCHES["gated_attention_bwd_dkv"] == before["gated_attention_bwd_dkv"] + 1
    assert ga.LAUNCHES["gated_attention_bwd_dq"] == before["gated_attention_bwd_dq"] + 1
    for g, w in zip(got, ga.gated_attention_bwd_ref(q, k, v, do)):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= cs.BWD_TOL * float(w.abs().max())
    again = ga.gated_attention_bwd_bh(q, k, v, do)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("dh,H,Hkv", [(128, 24, 8), (256, 16, 8)])
def test_gated_attention_autograd_wide_gqa_is_the_kernels(dev, dh, H, Hkv):
    """phi4-mini's (24 : 8) and gemma3's (16 : 8) GQA under autograd at
    their head dims: the kernels launch and the gradients equal autograd of
    the plain σ attention core within 1e-5 of each gradient's max."""
    from repro_torch.models.attention import attention_core, make_mask

    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn((1, 130, h, dh), generator=gen, device=dev) * s
               for h, s in ((H, 0.5), (Hkv, 0.5), (Hkv, 1.0)))
    go = torch.randn((1, 130, H * dh), generator=gen, device=dev)
    before = dict(ga.LAUNCHES)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad((ga.gated_attention(*leaves) * go).sum(), leaves)
    assert {key: ga.LAUNCHES[key] - before[key] for key in before} == {
        "gated_attention": 1, "gated_attention_bwd_dkv": 1, "gated_attention_bwd_dq": 1}
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    plain = attention_core(*leaves, make_mask(130, 130, causal=True, window=None, device=dev),
                           softmax=False)
    want = torch.autograd.grad((plain * go).sum(), leaves)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_gated_attention_bwd_two_calls_are_bitwise_equal(dev):
    q, k, v, do = _bwd_inputs(dev, 12, 700)
    a = ga.gated_attention_bwd_bh(q, k, v, do)
    b = ga.gated_attention_bwd_bh(q, k, v, do)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_gated_attention_autograd_on_the_card_is_the_kernels(dev):
    """The model-layout wrapper under autograd (GQA 8 : 4, so a repeated
    head's gradient sums over its repeats): the forward and backward
    kernels launch, and the gradients equal autograd of the plain σ
    attention core within 1e-5 of each gradient's max."""
    from repro_torch.models.attention import attention_core, make_mask

    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn((2, 150, h, 64), generator=gen, device=dev) * s
               for h, s in ((8, 0.5), (4, 0.5), (4, 1.0)))
    go = torch.randn((2, 150, 512), generator=gen, device=dev)
    before = dict(ga.LAUNCHES)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad((ga.gated_attention(*leaves) * go).sum(), leaves)
    assert {key: ga.LAUNCHES[key] - before[key] for key in before} == {
        "gated_attention": 1, "gated_attention_bwd_dkv": 1, "gated_attention_bwd_dq": 1}
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    plain = attention_core(*leaves, make_mask(150, 150, causal=True, window=None, device=dev),
                           softmax=False)
    want = torch.autograd.grad((plain * go).sum(), leaves)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_gated_attention_bwd_refuses_what_it_does_not_take(dev):
    """dh = 96 and dv != dh raise, naming the head dims the kernels take;
    the wide launchers refuse dh = 96 too; nq != nk raises."""
    from repro_torch.kernels._launch import bind, stream_of

    x = torch.zeros((2, 8, 96), device=dev)
    with pytest.raises(ValueError, match=r"dh = dv in \(64, 128, 256\), got dh=96 dv=96"):
        ga.gated_attention_bwd_bh(x, x, x, x)
    fn = bind("gated_attention_bwd", "gated_attention_bwd_wide_dkv_launch",
              ga.ops.BWD_WIDE_DKV_ARGTYPES)
    assert fn(*[x.data_ptr()] * 6, 2, 8, 96, 96 ** -0.5, stream_of(dev)) != 0
    x = torch.zeros((2, 8, 128), device=dev)
    with pytest.raises(ValueError, match="got dh=128 dv=64"):
        ga.gated_attention_bwd_bh(x, x, x[..., :64].contiguous(), x)
    q, k = torch.zeros((2, 8, 64), device=dev), torch.zeros((2, 9, 64), device=dev)
    with pytest.raises(ValueError, match="nq = nk"):
        ga.gated_attention_bwd_bh(q, k, k, q)


def test_train_step_on_the_card_matches_the_cpu(dev):
    """One train step of the smoke VQ-OPT on the card against the CPU,
    same weights, batch and Gumbel noise (``chip_smoke.card_vs_cpu_step``):
    the loss and every gradient leaf within its tolerances, a VQ code
    flipped only at a near tie, and the gates held on a draw of noise in
    which none flipped."""
    from repro_torch.configs.vq_opt_125m import smoke_config

    out = cs.card_vs_cpu_step(smoke_config(), b=2, n=96)
    assert out["near_tie_flips"][-1] == 0 and out["noise_draws"] <= cs.TRAIN_DRAWS
    assert out["launches"]["gated_attention_bwd_dq"] == 2
