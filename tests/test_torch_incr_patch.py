"""The port's incremental column patch (``kernels/incr_patch``) and the
unfused edit step that runs it (``use_patch_kernel=True``) against the JAX
package: the Pallas kernel in interpret mode, its batched twin with
``row_valid``, the engine math, and the server on the port's test stream
(``tests/test_torch_batch_server.py``).
ΔT within 2e-5; all-masked rows exactly zero; codes and tokens equal."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import smoke_params  # noqa: E402
from repro.kernels.incr_patch import (  # noqa: E402
    incr_patch as jax_incr_patch, incr_patch_batched as jax_incr_patch_batched,
    incr_patch_ref as jax_incr_patch_ref,
)
from repro.serving.batch_server import BatchServer as RefServer  # noqa: E402
from repro.serving.jit_engine import JitIncrementalEngine as RefEngine  # noqa: E402
from repro_torch.configs.vq_opt_125m import smoke_config as port_smoke  # noqa: E402
from repro_torch.kernels.incr_patch import (  # noqa: E402
    LAUNCHES, incr_patch, incr_patch_batched, incr_patch_ref,
)
from repro_torch.serving.batch_server import BatchServer  # noqa: E402
from repro_torch.serving.jit_engine import JitIncrementalEngine, weights_from_params  # noqa: E402
from test_torch_batch_server import DOCS, SERVER, _serve, _stream  # noqa: E402
from test_torch_jit_engine import C, R, _assert_close, _buckets, _run  # noqa: E402

ATOL = 2e-5


def _inputs(seed, lead_r, lead_c, H, dh, C_, Q, p=0.7):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (f(*lead_r, H, dh), f(*lead_c, H, C_, dh), f(*lead_c, H, C_, dh),
            f(*lead_c, H, C_, Q), f(*lead_c, H, C_, Q),
            rng.random((*lead_r[:-1], lead_r[-1], C_)) < p)


@pytest.mark.parametrize("Rn,H,dh,C_,Q", [(64, 4, 64, 8, 64), (100, 12, 64, 16, 128),
                                          (7, 2, 32, 8, 64), (13, 3, 24, 5, 48)])
def test_incr_patch_matches_jax_kernel(Rn, H, dh, C_, Q):
    q, kn, ko, vn, vo, mask = _inputs(Rn + C_, (Rn,), (), H, dh, C_, Q)
    want = jax_incr_patch(*(jnp.asarray(a) for a in (q, kn, ko, vn, vo, mask)),
                          block_r=32)
    got = incr_patch(*(torch.tensor(a) for a in (q, kn, ko, vn, vo, mask)))
    assert got.shape == (Rn, H, Q) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-5)
    ref = jax_incr_patch_ref(*(jnp.asarray(a) for a in (q, kn, ko, vn, vo)),
                             jnp.asarray(mask, jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("B,Rn,H,dh,C_,Q", [(2, 13, 3, 24, 5, 48), (3, 9, 2, 16, 3, 40),
                                            (2, 70, 4, 64, 72, 64)])
def test_incr_patch_batched_with_row_valid_matches_jax(B, Rn, H, dh, C_, Q):
    q, kn, ko, vn, vo, mask = _inputs(B + Rn + C_, (B, Rn), (B,), H, dh, C_, Q, p=0.6)
    row_valid = np.random.default_rng(B).random((B, Rn)) < 0.8
    args_j = [jnp.asarray(a) for a in (q, kn, ko, vn, vo, mask)]
    args_t = [torch.tensor(a) for a in (q, kn, ko, vn, vo, mask)]
    want = jax_incr_patch_batched(*args_j, row_valid=jnp.asarray(row_valid), block_r=8)
    got = incr_patch_batched(*args_t, row_valid=torch.tensor(row_valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-5)
    np.testing.assert_array_equal(got.numpy()[~row_valid], 0.0)
    for b in range(B):  # slice b equals the unbatched call on document b
        one = incr_patch(*(a[b] for a in args_t), row_valid=torch.tensor(row_valid[b]))
        np.testing.assert_allclose(one.numpy(), got[b].numpy(), atol=1e-6, rtol=1e-6)


def test_all_masked_rows_and_documents_are_exactly_zero():
    B, Rn, H, dh, C_, Q = 2, 11, 2, 16, 4, 32
    q, kn, ko, vn, vo, mask = _inputs(5, (B, Rn), (B,), H, dh, C_, Q, p=0.6)
    mask[0, 3] = False  # one fully masked row
    mask[1] = False  # one fully masked document
    out = incr_patch_batched(*(torch.tensor(a) for a in (q, kn, ko, vn, vo, mask)))
    np.testing.assert_array_equal(out[0, 3].numpy(), 0.0)
    np.testing.assert_array_equal(out[1].numpy(), 0.0)
    assert (out[0].abs().sum((-1, -2)) > 0).sum() > 0  # the others do patch


@pytest.mark.parametrize("B,Rn,C_,two", [
    (1, 1024, 8, False), (2, 1024, 8, False), (4, 1024, 8, False),  # one column tile
    (1, 1024, 72, True), (2, 1024, 72, True),    # 3 tiles, a small grid
    (4, 1024, 72, False), (1, 4096, 72, False),  # 3 tiles, 768 (tile, head, doc)
    (4, 1024, 136, True), (1, 1024, 1032, True),  # 5 tiles and more
])
def test_split_rule_follows_the_measured_crossovers(B, Rn, C_, two):
    """The kernel's choice between one CTA a (row tile, head, document) and
    one a product, at the served shapes (H=12): a function of the shape
    alone, fixed from chip_smoke.py --sweep on an H100."""
    from repro_torch.kernels.incr_patch import ops

    assert ops.split(B, Rn, 12, C_) is two


def test_plain_version_is_the_engine_math():
    """``incr_patch_ref`` on the kernel layout equals the inline einsums of
    ``JitIncrementalEngine`` ([B, C, H, dh] columns), row validity folded."""
    B, n, H, dh, C_, Q = 2, 20, 4, 64, 6, 64
    rng = np.random.default_rng(3)
    f = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32))
    q, kn, ko, vn, vo = f(B, n, H, dh), f(B, C_, H, dh), f(B, C_, H, dh), f(B, C_, H, Q), f(B, C_, H, Q)
    col_mask = torch.tensor(rng.random((B, n, C_)) < 0.5).float()
    row_valid = torch.tensor(rng.random((B, n)) < 0.8).float()
    cm = (col_mask * row_valid[:, :, None])[:, :, None, :]
    gelu = lambda s: torch.nn.functional.gelu(s, approximate="tanh")
    s_new = torch.einsum("bnhe,bche->bnhc", q, kn) * dh ** -0.5
    s_old = torch.einsum("bnhe,bche->bnhc", q, ko) * dh ** -0.5
    inline = (torch.einsum("bnhc,bchq->bnhq", gelu(s_new) * cm, vn)
              - torch.einsum("bnhc,bchq->bnhq", gelu(s_old) * cm, vo))
    t = lambda a: a.transpose(1, 2).contiguous()
    got = incr_patch_batched(q, t(kn), t(ko), t(vn), t(vo), col_mask, row_valid=row_valid)
    np.testing.assert_allclose(got.numpy(), inline.numpy(), atol=ATOL, rtol=1e-5)
    assert torch.equal(got, incr_patch_ref(q, t(kn), t(ko), t(vn), t(vo),
                                           col_mask * row_valid[:, :, None]))


@pytest.fixture(scope="module")
def setup():
    return smoke_params()


@pytest.mark.parametrize("seed", [0, 3])
def test_patch_kernel_engine_matches_reference_and_inline(setup, seed):
    cfg, params, np_params = setup
    weights = weights_from_params(np_params, port_smoke(), device="cpu")
    doc, steps = _buckets(cfg, seed)
    mk = lambda **kw: JitIncrementalEngine({}, port_smoke(), edit_capacity=C,
                                           row_capacity=R, device="cpu",
                                           _weights=weights, **kw)
    ref = RefEngine(params, cfg, edit_capacity=C, row_capacity=R, use_patch_kernel=True)
    to_host = lambda t: t.numpy()
    runs = zip(_run(ref, doc, steps, np.asarray),
               _run(mk(use_patch_kernel=True), doc, steps, to_host),
               _run(mk(), doc, steps, to_host))
    for (rs, ro), (ps, po), (ins, io) in runs:
        assert po == ro == io
        _assert_close(rs, ps)
        assert torch.equal(ps.codes, ins.codes)
        np.testing.assert_allclose(ps.T.numpy(), ins.T.numpy(), atol=ATOL, rtol=1e-5)


def test_fused_kernel_overrides_patch_kernel(setup):
    _, _, np_params = setup
    eng = JitIncrementalEngine(np_params, port_smoke(), use_patch_kernel=True,
                               use_fused_kernel=True, device="cpu")
    assert eng.use_fused_kernel and eng.use_patch_kernel  # fused is taken first


def test_patch_kernel_server_matches_fused_and_reference(setup):
    """The port's server test stream (a grow, a defrag and an overflow) through
    ``use_patch_kernel=True``: tokens, codes and counters equal the fused
    port server's and the reference's patch-kernel server's."""
    cfg, params, np_params = setup
    stream = _stream(cfg.vocab)
    patch = BatchServer(np_params, port_smoke(), device="cpu", use_fused_kernel=False,
                        use_patch_kernel=True, **SERVER)
    fused = BatchServer(np_params, port_smoke(), device="cpu", **SERVER)
    ref = RefServer(params, cfg, use_fused_kernel=False, use_patch_kernel=True, **SERVER)
    before = dict(LAUNCHES)
    for srv in (patch, fused, ref):
        _serve(srv, stream)
    assert LAUNCHES == before  # the plain version ran: CPU calls do not count
    for name in ("grows", "defrags", "overflows", "full_forwards", "batch_steps",
                 "edits_applied"):
        assert getattr(patch.stats, name) == getattr(fused.stats, name) \
            == getattr(ref.stats, name), name
    assert patch.stats.grows >= 1 and patch.stats.defrags >= 1 and patch.stats.overflows >= 1
    for did in DOCS:
        np.testing.assert_array_equal(patch.tokens(did), ref.tokens(did))
        np.testing.assert_array_equal(patch.tokens(did), fused.tokens(did))
        np.testing.assert_array_equal(patch.state(did).codes.numpy(),
                                      np.asarray(ref.state(did).codes))
        assert torch.equal(patch.state(did).codes, fused.state(did).codes)
        np.testing.assert_allclose(patch.logits(did), np.asarray(ref.logits(did)), atol=3e-4)
        np.testing.assert_allclose(patch.logits(did), fused.logits(did), atol=3e-4)
