"""The benchmark's frozen copies equal today's originals: the work
arithmetic of ``chip_smoke.py`` and ``launch/roofline.py`` at the served
shapes of PERF.md's kernel table (the originals' peaks aside), and the
serving allocator's position ids and edit application under the mix's
edit streams."""
from __future__ import annotations

import numpy as np
import pytest

import _smoke  # noqa: F401  (puts src/ and the repository on the path)
from portbench import generate, work
from portbench.reference import docs as refdocs

FUSED = [(1, 1024, C) for C in (8, 72, 136, 264, 520, 1032)] + \
        [(B, 1024, C) for B in (2, 4) for C in (8, 72, 136, 264)]
ATTN = [(48, n, n, 64) for n in (37, 128, 256, 512, 1000, 1024, 2048)] + \
       [(12, 1024, 1024, 64), (48, 1024, 512, 64), (48, 512, 1024, 64),
        (24, 4096, 4096, 128), (24, 1000, 1000, 128), (16, 3072, 3072, 256), (25, 4096, 4096, 64)]
BWD = [(96, 1024, 64), (48, 1024, 64), (48, 1000, 64), (48, 37, 64), (48, 1, 64),
       (24, 4096, 128), (16, 4096, 256), (25, 4096, 64)]
VQ = [(1024, 2, 64, 384), (4096, 2, 64, 1536), (1, 2, 64, 1536), (3072, 2, 64, 2048),
      (4096, 2, 64, 800), (4096, 2, 64, 8192), (4096, 2, 64, 384)]


@pytest.fixture(scope="module")
def smoke():
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("shape", ATTN)
def test_attention_work(smoke, shape):
    assert work.attention_work(*shape) == smoke.attention_work(*shape)


@pytest.mark.parametrize("shape", BWD)
def test_attention_bwd_work(smoke, shape):
    assert work.attention_bwd_work(*shape) == smoke.attention_bwd_work(*shape)


@pytest.mark.parametrize("B,n,C", FUSED)
def test_fused_step_work(smoke, B, n, C):
    """The bytes and operations ``check_fused_step`` prices a launch at,
    for the live count of a random mask."""
    import torch

    H, dh, Q, hq = 12, 64, 64, 2
    args = [torch.zeros(s) for s in ((B, n, H, dh), (B, H, C, dh), (B, H, C, dh),
                                     (B, H, C, Q), (B, H, C, Q), (B, n, C), (B, n, H, Q),
                                     (B, n), (hq, Q))]
    live = float(int(0.37 * B * n * C))
    nbytes = 4 * (sum(a.numel() for a in args) + B * n * H * Q + B * n * hq)
    flops = live * H * (4 * dh + 4 * Q) + 2 * B * n * H * Q + 2 * B * n * hq * Q
    assert work.fused_step_work(B, n, C, H, dh, Q, hq, live) == (nbytes, flops)
    ms, _ = smoke.bound(nbytes, flops, peak=work.PEAK_FLOPS)
    assert work.bound_s(nbytes, flops) * 1e3 == pytest.approx(ms, rel=1e-12)


@pytest.mark.parametrize("M,hq,Q,dv", VQ)
def test_vq_assign_work(smoke, M, hq, Q, dv):
    nbytes = 4 * (2 * M * hq * dv + hq * Q * dv + M * hq)  # check_vq_assign's, B·N = M
    assert work.vq_assign_work(M, hq, Q, dv) == (nbytes, 2 * M * hq * Q * dv)


@pytest.mark.parametrize("n_cap,C,R", [(1024, 8, 256), (1024, 8, 1024), (4096, 1, 1),
                                        (256, 8, 64), (1024, 1, 1)])
def test_edit_step_flops(n_cap, C, R):
    from repro_torch.launch import roofline

    meta = dict(d=768, H=12, dh=64, Q=64)
    assert work.edit_step_flops(12, meta, n_cap, C, R, 3072) == \
        roofline.edit_step_flops(12, meta, n_cap, C, R, 3072)


@pytest.mark.parametrize("seed", [0, 1, 3_000_000_123])
def test_positions_follow_the_serving_allocator(seed):
    """The mix's edits, in a small pool so gaps run out, give the program's
    ``PositionAllocator`` and ``core.edits`` the same ids and tokens."""
    from repro_torch.core.edits import Edit, apply_edit
    from repro_torch.core.positional import PositionAllocator

    spec = _smoke.traffic("edits", docs=3, len_min=20, len_max=60)
    texts = generate.documents(spec, 100, seed)
    writers = generate.Writers(spec, [len(t) for t in texts], 100, seed)
    pool = 400
    mine = [refdocs.Document(t, pool) for t in texts]
    theirs = [(PositionAllocator(len(t), pool), list(map(int, t))) for t in texts]
    defrags = 0
    for _ in range(30):
        for w, op, pos, tok, n in writers.next_round():
            assert len(mine[w]) == n
            mine[w].apply(op, pos, tok)
            alloc, toks = theirs[w]
            if op == "insert" and not alloc.can_insert_at(pos):
                alloc.defragment()
                defrags += 1
            if op == "insert":
                alloc.insert_at(pos)
            elif op == "delete":
                alloc.delete_at(pos)
            theirs[w] = (alloc, apply_edit(toks, Edit(op, pos, tok)))
    for d, (alloc, toks) in zip(mine, theirs):
        assert d.tokens == toks
        assert np.array_equal(np.asarray(d.positions), alloc.snapshot())
    assert defrags == sum(d.defrags for d in mine) > 0
