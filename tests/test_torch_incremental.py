"""The port's op-counting ``IncrementalEngine`` (``repro_torch.core.
incremental``) against the JAX package's NumPy engine on the smoke config's
weights, on the CPU: the same codes, hidden states within 5e-5, logits
within 2e-4, and exactly the same op counts edit by edit — the paper's
metric must not depend on which package metered it. Each edit is also held
to the port's own ``full_forward`` of the edited document (the exactness
invariant). Fixed seeds, so the count of cases is steady."""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_parity import smoke_params  # noqa: E402
from repro.core import edits as redits  # noqa: E402
from repro.core.incremental import IncrementalEngine as RefEngine  # noqa: E402
from repro.core.opcount import OpCounter as RefCounter  # noqa: E402
from repro.core.opcount import dense_transformer_forward_ops as ref_dense  # noqa: E402
from repro.core.positional import PositionAllocator as RefAllocator  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.configs.vq_opt_125m import smoke_config  # noqa: E402
from repro_torch.core.edits import Edit  # noqa: E402
from repro_torch.core.incremental import IncrementalEngine  # noqa: E402
from repro_torch.core.opcount import OpCounter, dense_transformer_forward_ops  # noqa: E402
from repro_torch.core.positional import PositionAllocator  # noqa: E402
from repro_torch.models.transformer import forward, params_from_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def setup():
    cfg_ref, params, np_params = smoke_params()
    rc, pc = RefCounter(), OpCounter()
    ref = RefEngine(params, cfg_ref, rc)
    eng = IncrementalEngine(np_params, smoke_config(), pc, device="cpu")
    return smoke_config(), np_params, ref, eng


def _doc(cfg, n=48, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, n), np.arange(n) * 7  # gapped ids


def _assert_equal_ref(ref_state, state, atol=5e-5):
    """The port's state against the reference's: codes equal, xs close."""
    assert np.array_equal(state.tokens, ref_state.tokens)
    assert np.array_equal(state.positions, ref_state.positions)
    for lr, lp in zip(ref_state.layers, state.layers, strict=True):
        np.testing.assert_array_equal(lp.codes.numpy(), lr.codes)
    for xr, xp in zip(ref_state.xs, state.xs, strict=True):
        np.testing.assert_allclose(xp.numpy(), xr, atol=atol)


def _assert_exact(eng, state, atol=5e-5):
    """The port's incremental state against its own full forward."""
    full = eng.full_forward(state.tokens, state.positions)
    for la, lb in zip(state.layers, full.layers, strict=True):
        assert torch.equal(la.codes, lb.codes)
    for xa, xb in zip(state.xs, full.xs, strict=True):
        np.testing.assert_allclose(xa.numpy(), xb.numpy(), atol=atol)


def _metered(engine, fn, *args):
    """(fn(*args), the ops its engine's counter added)."""
    before = engine.counter.total
    out = fn(*args)
    return out, engine.counter.total - before


def _both(ref, eng, name, ref_args, args):
    """One method on both engines: returns both results; op counts equal."""
    r, r_ops = _metered(ref, getattr(ref, name), *ref_args)
    p, p_ops = _metered(eng, getattr(eng, name), *args)
    assert p_ops == r_ops, (name, p_ops, r_ops)
    return r, p


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_full_forward_matches_reference(setup, seed):
    cfg, _, ref, eng = setup
    tokens, positions = _doc(cfg, n=40 + 8 * seed, seed=seed)
    ref.counter.counts.clear()
    eng.counter.counts.clear()
    r, p = _both(ref, eng, "full_forward", (tokens, positions), (tokens, positions))
    _assert_equal_ref(r, p)
    assert eng.counter.summary() == ref.counter.summary()
    for row in (-1, 0, len(tokens) // 2):
        np.testing.assert_allclose(eng.logits_at(p, row).numpy(),
                                   ref.logits_at(r, row), atol=2e-4)
    assert eng.counter.summary() == ref.counter.summary()


def test_engine_matches_the_ports_forward(setup):
    """``logits_at`` of the engine's full forward equals the port's model
    forward (``models.transformer.forward``) at the last row."""
    cfg, np_params, _, eng = setup
    tokens, positions = _doc(cfg)
    st = eng.full_forward(tokens, positions)
    logits, _ = forward(params_from_numpy(np_params, device="cpu"), cfg,
                        torch.as_tensor(tokens)[None], torch.as_tensor(positions)[None])
    np.testing.assert_allclose(eng.logits_at(st).numpy(), logits[0, -1].numpy(), atol=2e-4)


@pytest.mark.parametrize("seed,n_edits", [(0, 1), (1, 2), (2, 3), (3, 4), (4, 4)])
def test_replace_exactness(setup, seed, n_edits):
    cfg, _, ref, eng = setup
    tokens, positions = _doc(cfg, seed=seed % 7)
    r, p = ref.full_forward(tokens, positions), eng.full_forward(tokens, positions)
    rng = np.random.default_rng(seed)
    pos_list = [int(i) for i in rng.choice(len(tokens), n_edits, replace=False)]
    new_toks = [int(t) for t in rng.integers(0, cfg.vocab, n_edits)]
    r, p = _both(ref, eng, "apply_replaces", (r, pos_list, new_toks), (p, pos_list, new_toks))
    _assert_equal_ref(r, p)
    _assert_exact(eng, p)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_insert_exactness(setup, seed):
    cfg, _, ref, eng = setup
    tokens, positions = _doc(cfg, seed=seed % 5)
    r0, p0 = ref.full_forward(tokens, positions), eng.full_forward(tokens, positions)
    rng = np.random.default_rng(seed)
    p = int(rng.integers(0, len(tokens) + 1))
    lo = positions[p - 1] if p > 0 else -1
    hi = positions[p] if p < len(tokens) else positions[-1] + 8
    pid, tok = int((lo + hi) // 2), int(rng.integers(0, cfg.vocab))
    r, q = _both(ref, eng, "apply_insert", (r0, p, tok, pid), (p0, p, tok, pid))
    _assert_equal_ref(r, q)
    _assert_exact(eng, q)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_delete_exactness(setup, seed):
    cfg, _, ref, eng = setup
    tokens, positions = _doc(cfg, seed=seed % 5)
    r0, p0 = ref.full_forward(tokens, positions), eng.full_forward(tokens, positions)
    p = int(np.random.default_rng(seed).integers(0, len(tokens)))
    if seed == 3:
        p = len(tokens) - 1  # the last row: no later rows, nothing to patch
    r, q = _both(ref, eng, "apply_delete", (r0, p), (p0, p))
    _assert_equal_ref(r, q)
    _assert_exact(eng, q)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_edit_stream_exactness(setup, seed):
    """A 5-edit mixed replace/insert/delete stream with a real allocator:
    every edit's op count equals the reference's, and the final state
    equals the port's full forward."""
    cfg, _, ref, eng = setup
    rng = np.random.default_rng(seed)
    n = 32
    tokens = [int(t) for t in rng.integers(0, cfg.vocab, n)]
    ra, pa = RefAllocator(n, pool_size=cfg.pos_pool), PositionAllocator(n, pool_size=cfg.pos_pool)
    r, p = ref.full_forward(tokens, ra.positions), eng.full_forward(tokens, pa.positions)
    for _ in range(5):
        op = ["replace", "insert", "delete"][rng.integers(3)]
        if op == "replace":
            e = Edit("replace", int(rng.integers(len(tokens))), int(rng.integers(cfg.vocab)))
        elif op == "insert":
            e = Edit("insert", int(rng.integers(len(tokens) + 1)), int(rng.integers(cfg.vocab)))
        else:
            e = Edit("delete", int(rng.integers(len(tokens))))
        r, r_ops = _metered(ref, ref.apply_edit, r, redits.Edit(e.op, e.pos, e.token), ra)
        p, p_ops = _metered(eng, eng.apply_edit, p, e, pa)
        assert p_ops == r_ops, (e, p_ops, r_ops)
        assert pa.positions == ra.positions
        tokens = redits.apply_edit(tokens, e)
    _assert_equal_ref(r, p)
    _assert_exact(eng, p)
    assert list(p.tokens) == tokens


@pytest.mark.parametrize("seed,frac", [(0, 0.02), (1, 0.1), (2, 0.3), (3, 0.3)])
def test_apply_revision_exactness(setup, seed, frac):
    """The batched offline revision (one column-patch sweep per layer)."""
    cfg, _, ref, eng = setup
    rng = np.random.default_rng(seed)
    n = 48
    tokens = rng.integers(0, cfg.vocab, n)
    ra, pa = RefAllocator(n, cfg.pos_pool), PositionAllocator(n, cfg.pos_pool)
    r0, p0 = ref.full_forward(tokens, ra.positions), eng.full_forward(tokens, pa.positions)
    new = np.asarray(redits.random_revision(rng, tokens, cfg.vocab, frac))
    r, p = _both(ref, eng, "apply_revision", (r0, new, ra), (p0, new, pa))
    assert pa.positions == ra.positions
    _assert_equal_ref(r, p)
    _assert_exact(eng, p)


def test_revision_without_room_defragments(setup):
    """A revision whose inserted run does not fit its gap falls back to a
    (counted) full forward on re-spread ids, as the reference does."""
    cfg, _, ref, eng = setup
    tokens = np.arange(20) % cfg.vocab
    positions = np.arange(20)  # no gaps at all
    r0, p0 = ref.full_forward(tokens, positions), eng.full_forward(tokens, positions)
    new = np.insert(tokens, 10, [5, 6, 7])
    r, p = _both(ref, eng, "apply_revision", (r0, new), (p0, new))
    _assert_equal_ref(r, p)


@pytest.mark.parametrize("mix", ["replace_only", "mixed"])
def test_edit_mix_trace_op_counts_equal_the_reference(setup, mix):
    """The op phase of ``benchmarks/edit_mix.py`` (doc_len 64, 8 edits,
    PRNGKey(0) weights, ``default_rng(0)``) through both packages'
    ``IncrementalServer``: every edit's ops, the totals and the counter's
    summary are equal. The reference's totals are computed here, not
    written down (70,236,448 replace-only and 74,340,672 mixed with the
    reference of this writing)."""
    sys.path.insert(0, str(ROOT))
    from benchmarks.edit_mix import MIXES, _stream
    from repro.configs.vq_opt_125m import smoke_config as ref_smoke
    from repro.serving.engine import IncrementalServer as RefServer

    from _torch_parity import params_to_numpy
    from repro_torch.serving.engine import IncrementalServer

    cfg_ref = ref_smoke(vqt=True)
    params = jax.device_get(RT.init_params(jax.random.PRNGKey(0), cfg_ref))
    # ``run()``'s draws: n_docs=4 documents from the stream's generator,
    # the op view edits the first
    rng, rng_port = np.random.default_rng(0), np.random.default_rng(0)
    base = [list(rng.integers(0, cfg_ref.vocab, 64)) for _ in range(4)][0]
    assert [list(rng_port.integers(0, cfg_ref.vocab, 64)) for _ in range(4)][0] == base
    rs = RefServer(params, cfg_ref)
    ps = IncrementalServer(params_to_numpy(params), smoke_config(), device="cpu")
    rs.open_document("d0", list(base))
    ps.open_document("d0", list(base))
    ref_tokens, port_tokens = list(base), list(base)
    ref_ops, port_ops = [], []
    for (op, pos, tok), (op2, pos2, tok2) in zip(
            _stream(rng, ref_tokens, cfg_ref.vocab, MIXES[mix], 8),
            _stream(rng_port, port_tokens, cfg_ref.vocab, MIXES[mix], 8), strict=True):
        assert (op, pos, tok) == (op2, pos2, tok2)
        ref_ops.append(rs.apply_edit("d0", redits.Edit(op, pos, tok)))
        port_ops.append(ps.apply_edit("d0", Edit(op, pos, tok)))
    assert port_ops == ref_ops
    assert sum(port_ops) == sum(ref_ops)
    assert ps.counter.summary() == rs.counter.summary()
    assert list(ps.tokens("d0")) == list(rs.tokens("d0")) == ref_tokens
    assert ps.stats.full_ops_equiv == rs.stats.full_ops_equiv


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", pconfigs.all_arch_names())
def test_dense_forward_ops_equal_the_reference(name, smoke):
    """The dense baseline the speedups divide by, for every config the port
    has, at several lengths, with and without the LM head and gating."""
    from repro.configs import get_config as ref_config

    c, r = pconfigs.get_config(name, smoke=smoke), ref_config(name, smoke=smoke)
    for n in (1, 64, 257, 2048):
        for gated in (False, True):
            for head in (False, True):
                kw = dict(n_layers=c.n_layers, d_model=c.d_model, n_heads=c.n_heads,
                          n_kv_heads=c.n_kv_heads, d_ff=c.d_ff, vocab=c.vocab,
                          seq_len=n, ffn_gated=gated, include_lm_head=head)
                ref_kw = dict(kw, n_layers=r.n_layers, d_model=r.d_model,
                              n_heads=r.n_heads, n_kv_heads=r.n_kv_heads,
                              d_ff=r.d_ff, vocab=r.vocab)
                assert dense_transformer_forward_ops(**kw) == ref_dense(**ref_kw)


def test_op_counter_conventions_equal_the_reference():
    ours, theirs = OpCounter(), RefCounter()
    for c in (ours, theirs):
        c.matmul("a", 3, 5, 7)
        c.elementwise("b", 11, 8)
        c.add("a", 2.9)
        other = type(c)()
        other.elementwise("c", 4)
        c.merge(other)
    assert ours.summary() == theirs.summary()
    assert ours.total == theirs.total == 2 * 3 * 5 * 7 + 88 + 2 + 4
