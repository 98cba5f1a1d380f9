"""The port's linear-recurrence core (``repro_torch.models.linear_scan``)
and GroupNorm against the reference's on the same numpy-seeded inputs:
the sequential scan, the chunked scan and the decode step, both
``mamba_style`` values, with and without a bonus ``u`` and an initial state
``s0``, n a multiple of the chunk and not (zero-padded as the mixers pad).
Port against reference within 1e-5; the port's chunked scan against its own
sequential scan within 1e-4 (``tests/test_models.py:150-151``)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import linear_scan as RS  # noqa: E402
from repro.models.norms import groupnorm as ref_groupnorm  # noqa: E402
from repro_torch.models import linear_scan as PS  # noqa: E402
from repro_torch.models.norms import groupnorm  # noqa: E402

B, H, DK, DV = 2, 3, 8, 6
ATOL = 1e-5
CASES = [(m, u, s0) for m in (False, True) for u in (False, True) for s0 in (False, True)]


def _inputs(seed, n, decay=0.3):
    """q, k, v, logw [b, h, n, *], u [h, dk] and s0 [b, h, dk, dv] as numpy;
    ``decay`` scales |logw| (2.0 puts some steps below MIN_LOGW's clip)."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    q, k, v = f(B, H, n, DK, scale=0.5), f(B, H, n, DK, scale=0.5), f(B, H, n, DV)
    logw = -np.abs(f(B, H, n, DK)) * decay
    return q, k, v, logw, f(H, DK, scale=0.5), f(B, H, DK, DV, scale=0.5)


def _both(a, use):
    return (jnp.asarray(a), torch.tensor(a)) if use else (None, None)


def _pad(a, n_to):
    return np.pad(a, ((0, 0), (0, 0), (0, n_to - a.shape[2]), (0, 0)))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=atol)


_ref_seq = jax.jit(RS.lin_attn_sequential, static_argnames="mamba_style")
_ref_chunked = jax.jit(RS.lin_attn_chunked, static_argnames=("mamba_style", "chunk"))


@pytest.mark.parametrize("mamba_style,use_u,use_s0", CASES)
def test_sequential_matches_reference(mamba_style, use_u, use_s0):
    q, k, v, logw, u, s0 = _inputs(0, 37)
    (uj, ut), (sj, st) = _both(u, use_u), _both(s0, use_s0)
    yj, Sj = _ref_seq(*map(jnp.asarray, (q, k, v, logw)), uj, sj, mamba_style=mamba_style)
    yt, St = PS.lin_attn_sequential(*map(torch.tensor, (q, k, v, logw)), ut, st,
                                    mamba_style=mamba_style)
    assert yt.shape == (B, H, 37, DV) and St.shape == (B, H, DK, DV)
    _close(yt.numpy(), yj)
    _close(St.numpy(), Sj)


@pytest.mark.parametrize("n", [48, 37])
@pytest.mark.parametrize("mamba_style,use_u,use_s0", CASES)
def test_chunked_matches_reference_and_own_sequential(mamba_style, use_u, use_s0, n):
    """n = 37 is zero-padded to 48 as the mixers pad it: the padded steps
    (logw = 0, k = 0) leave the final state as the sequential scan's over
    the 37 real steps."""
    q, k, v, logw, u, s0 = _inputs(1, n)
    (uj, ut), (sj, st) = _both(u, use_u), _both(s0, use_s0)
    padded = [_pad(a, 48) for a in (q, k, v, logw)]
    yj, Sj = _ref_chunked(*map(jnp.asarray, padded), uj, sj, mamba_style=mamba_style)
    yt, St = PS.lin_attn_chunked(*map(torch.tensor, padded), ut, st, mamba_style=mamba_style)
    _close(yt.numpy(), yj)
    _close(St.numpy(), Sj)
    ys, Ss = PS.lin_attn_sequential(*map(torch.tensor, (q, k, v, logw)), ut, st,
                                    mamba_style=mamba_style)
    _close(yt[:, :, :n].numpy(), ys.numpy(), atol=1e-4)
    _close(St.numpy(), Ss.numpy(), atol=1e-4)


@pytest.mark.parametrize("mamba_style", [False, True])
@pytest.mark.parametrize("chunk", [16, 8])
def test_chunked_holds_past_the_decay_clip(mamba_style, chunk):
    """Decays below e^-5 a step are clipped to it, so exp(-W) reaches e^80
    inside a 16-step chunk and still stays finite in f32: the chunked scan
    within 1e-4 of the sequential one, and of the reference's."""
    q, k, v, logw, u, _ = _inputs(2, 64, decay=3.0)
    assert (logw < PS.MIN_LOGW).mean() > 0.05
    t = [torch.tensor(a) for a in (q, k, v, logw)]
    yc, Sc = PS.lin_attn_chunked(*t, torch.tensor(u), mamba_style=mamba_style, chunk=chunk)
    ys, Ss = PS.lin_attn_sequential(*t, torch.tensor(u), mamba_style=mamba_style)
    assert bool(torch.isfinite(yc).all())
    _close(yc.numpy(), ys.numpy(), atol=1e-4)
    _close(Sc.numpy(), Ss.numpy(), atol=1e-4)
    yj, _ = _ref_chunked(*map(jnp.asarray, (q, k, v, logw)), jnp.asarray(u),
                         mamba_style=mamba_style, chunk=chunk)
    _close(yc.numpy(), yj)


def test_chunked_refuses_a_ragged_length():
    q, k, v, logw, _, _ = _inputs(3, 37)
    with pytest.raises(ValueError, match="multiple of chunk 16"):
        PS.lin_attn_chunked(*map(torch.tensor, (q, k, v, logw)))


@pytest.mark.parametrize("mamba_style,use_u", [(m, u) for m in (False, True)
                                               for u in (False, True)])
def test_decode_steps_match_reference_and_the_scan(mamba_style, use_u):
    """Token-by-token decode from ``s0``: each step within 1e-5 of the
    reference's, and the stacked steps equal to the sequential scan."""
    q, k, v, logw, u, s0 = _inputs(4, 10)
    (uj, ut) = _both(u, use_u)
    step_j = jax.jit(RS.lin_attn_decode_step, static_argnames="mamba_style")
    Sj, St = jnp.asarray(s0), torch.tensor(s0)
    ys = []
    for t in range(10):
        at = lambda a: a[:, :, t]  # noqa: E731
        yj, Sj = step_j(*(jnp.asarray(at(a)) for a in (q, k, v, logw)), Sj, uj,
                        mamba_style=mamba_style)
        yt, St = PS.lin_attn_decode_step(*(torch.tensor(at(a)) for a in (q, k, v, logw)),
                                         St, ut, mamba_style=mamba_style)
        _close(yt.numpy(), yj)
        _close(St.numpy(), Sj)
        ys.append(yt)
    y_seq, S_seq = PS.lin_attn_sequential(*map(torch.tensor, (q, k, v, logw)), ut,
                                          torch.tensor(s0), mamba_style=mamba_style)
    _close(torch.stack(ys, 2).numpy(), y_seq.numpy())
    _close(St.numpy(), S_seq.numpy())


@pytest.mark.parametrize("groups", [1, 4])
def test_groupnorm_matches_reference(groups):
    """Population variance, eps 64e-5, per group of the last dim."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 5, 32)) * 3 + 1).astype(np.float32)
    x[0, 0, :8] = 0.25  # a constant group: var 0, the eps alone
    scale = rng.standard_normal(32).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    want = ref_groupnorm(jnp.asarray(x), groups, jnp.asarray(scale), jnp.asarray(bias))
    got = groupnorm(torch.tensor(x), groups, torch.tensor(scale), torch.tensor(bias))
    _close(got.numpy(), want)
