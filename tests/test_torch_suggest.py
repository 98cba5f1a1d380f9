"""Suggestion serving on the port (``serving/suggest``, the suggestion
wiring of ``serving/batch_server``) against the JAX package on the smoke
config's weights: after EVERY edit of a mixed stream the port's suggestion
equals the reference's and the port's own from-scratch ``oracle_suggestion``
token for token, and the reuse counts (``SuggestStats``) and the server's
suggestion counters equal the reference's — through a forced grow, a forced
defrag (tiny pool) and a position-headroom defrag."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import smoke_params  # noqa: E402
from repro.serving.batch_server import BatchServer as RefServer  # noqa: E402
from repro.serving.jit_engine import JitIncrementalEngine as RefEngine  # noqa: E402
from repro.serving.suggest import SuggestionEngine as RefSuggester  # noqa: E402
from repro_torch.configs.vq_opt_125m import smoke_config as port_smoke  # noqa: E402
from repro_torch.models.transformer import params_from_numpy  # noqa: E402
from repro_torch.serving.batch_server import BatchServer  # noqa: E402
from repro_torch.serving.jit_engine import JitIncrementalEngine  # noqa: E402
from repro_torch.serving.suggest import (  # noqa: E402
    PositionHeadroomError, SuggestionEngine, oracle_suggestion,
)

N_NEW = 4
POOL = 2048
SUGGEST_COUNTERS = ("suggest_refreshes", "suggest_invalidations", "suggest_cached_hits",
                    "grows", "defrags", "overflows", "full_forwards", "edits_applied",
                    "bytes_suggest")


@pytest.fixture(scope="module")
def setup():
    cfg, params, np_params = smoke_params()
    return cfg, params, np_params, params_from_numpy(np_params, device="cpu")


class _SlotDoc:
    """Host mirror of one slot-buffer document for engine-level streams."""

    def __init__(self, cfg, rng, n, n_cap):
        self.tokens = np.zeros(n_cap, np.int32)
        self.tokens[:n] = rng.integers(0, cfg.vocab, n)
        self.positions = np.full(n_cap, POOL - 1, np.int32)
        self.positions[:n] = (np.arange(1, n + 1) * POOL) // (n + 1)
        self.valid = np.zeros(n_cap, bool)
        self.valid[:n] = True
        self.slots = list(range(n))
        self.free = list(range(n_cap - 1, n - 1, -1))

    def edit(self, cfg, rng):
        """A random edit as a one-entry bucket (slot, tok, pid, op) padded
        to 4, and the edited position id; None when the gap is exhausted."""
        kind = rng.choice(["replace", "insert", "delete"])
        nn = len(self.slots)
        seq_pos = self.positions[np.asarray(self.slots)]
        if kind == "insert" and self.free:
            p = int(rng.integers(nn + 1))
            lo = seq_pos[p - 1] if p > 0 else -1
            hi = seq_pos[p] if p < nn else POOL
            if hi - lo <= 1:
                return None
            pid, t, s = int((lo + hi) // 2), int(rng.integers(cfg.vocab)), self.free.pop()
            self.slots.insert(p, s)
            self.tokens[s], self.positions[s], self.valid[s] = t, pid, True
            bucket = (s, t, pid, 1)
        elif kind == "delete" and nn > 2:
            s = self.slots.pop(int(rng.integers(nn)))
            self.free.append(s)
            self.valid[s] = False
            pid = int(self.positions[s])
            bucket = (s, 0, pid, 2)
        else:
            s = self.slots[int(rng.integers(nn))]
            t = int(rng.integers(cfg.vocab))
            self.tokens[s] = t
            pid = int(self.positions[s])
            bucket = (s, t, pid, 0)
        pad = lambda v, fill: np.array([v, fill, fill, fill], np.int32)
        return (pad(bucket[0], -1), pad(bucket[1], 0), pad(bucket[2], 0),
                pad(bucket[3], 0)), pid


@pytest.mark.parametrize("seed", [0, 7])
def test_engine_stream_matches_reference_and_oracle(setup, seed):
    cfg, params, np_params, tp = setup
    pcfg = port_smoke()
    ref_eng = RefEngine(params, cfg, edit_capacity=4, row_capacity=16)
    eng = JitIncrementalEngine(np_params, pcfg, edit_capacity=4, row_capacity=16,
                               device="cpu")
    ref_s, ours, oracle = RefSuggester(params, cfg), SuggestionEngine(tp, pcfg), \
        SuggestionEngine(tp, pcfg)
    rng = np.random.default_rng(seed)
    doc = _SlotDoc(cfg, rng, n=int(rng.integers(8, 13)), n_cap=16)
    rs = ref_eng.full_forward(*(jnp.asarray(a) for a in (doc.tokens, doc.positions, doc.valid)))
    ps = eng.full_forward(doc.tokens, doc.positions, doc.valid)
    got = ours.refresh(eng, ps, key="d", n_new=N_NEW)
    np.testing.assert_array_equal(got, ref_s.refresh(ref_eng, rs, key="d", n_new=N_NEW))
    touched, applied = None, 0
    while applied < 8:
        e = doc.edit(cfg, rng)
        if e is None:
            continue
        (slot, tok, pid_a, op), pid = e
        applied += 1
        rs, r_ovf = ref_eng.apply_edits(rs, *(jnp.asarray(a) for a in (slot, tok, pid_a, op)))
        ps, p_ovf = eng.apply_edits(ps, slot, tok, pid_a, op)
        assert not bool(r_ovf) and not bool(p_ovf)
        touched = pid if touched is None else min(touched, pid)
        kw = dict(key="d", n_new=N_NEW, invalid_from=pid, export_invalid_from=touched)
        got = ours.refresh(eng, ps, **kw)
        np.testing.assert_array_equal(got, ref_s.refresh(ref_eng, rs, **kw),
                                      err_msg=f"edit {applied}")
        want = oracle_suggestion(tp, pcfg, eng, doc.tokens, doc.positions, doc.valid,
                                 N_NEW, suggester=oracle)
        np.testing.assert_array_equal(got, want, err_msg=f"edit {applied}")
    assert dataclasses.asdict(ours.stats) == dataclasses.asdict(ref_s.stats)
    assert ours.stats.prefill_rows_reused > 0  # the reuse path ran
    assert ours.cache_nbytes("d") > 0
    ours.drop("d")
    assert ours.cache_nbytes("d") == 0


def test_stale_prefix_is_caught(setup):
    """A lying ``invalid_from`` (claiming an edited prefix is clean) is
    caught by the cached-prefix check and falls back to full re-prefill."""
    cfg, _, np_params, tp = setup
    pcfg = port_smoke()
    eng = JitIncrementalEngine(np_params, pcfg, edit_capacity=4, row_capacity=16,
                               device="cpu")
    sugg = SuggestionEngine(tp, pcfg)
    doc = _SlotDoc(cfg, np.random.default_rng(3), n=10, n_cap=16)
    st = eng.full_forward(doc.tokens, doc.positions, doc.valid)
    sugg.refresh(eng, st, key="s", n_new=N_NEW)
    s = doc.slots[0]
    doc.tokens[s] = (doc.tokens[s] + 1) % cfg.vocab
    st, _ = eng.apply_replaces(st, [s, -1, -1, -1], [int(doc.tokens[s]), 0, 0, 0])
    lie = int(doc.positions[doc.slots[-1]])
    got = sugg.refresh(eng, st, key="s", n_new=N_NEW, invalid_from=lie,
                       export_invalid_from=lie)
    want = oracle_suggestion(tp, pcfg, eng, doc.tokens, doc.positions, doc.valid, N_NEW)
    np.testing.assert_array_equal(got, want)


def test_headroom_error_names_the_defrag(setup):
    cfg, _, np_params, tp = setup
    pcfg = port_smoke()
    eng = JitIncrementalEngine(np_params, pcfg, device="cpu")
    toks = np.arange(4, dtype=np.int32)
    pos = np.array([10, 20, 30, cfg.pos_pool - 3], np.int32)
    with pytest.raises(PositionHeadroomError, match="defragment"):
        SuggestionEngine(tp, pcfg).refresh(eng, eng.full_forward(toks, pos), n_new=4)


def _edit(srv, did, e):
    kind, p, t = e
    if kind == "insert":
        srv.submit_insert(did, p, t)
    elif kind == "delete":
        srv.submit_delete(did, p)
    else:
        srv.submit_replace(did, p, t)


def test_server_stream_matches_reference_and_oracle(setup):
    """Three documents: "g" fills its capacity class (a grow), "d" takes
    inserts at one position in a tiny pool (gap exhaustion: defrags), "h"
    is appended to in a pool the size of the embedding table until its
    continuation would run past it (a headroom defrag and a retry)."""
    cfg, params, np_params, tp = setup
    pcfg = port_smoke()
    rng = np.random.default_rng(11)
    kw = dict(edit_capacity=4, row_capacity=16, max_batch=4, min_doc_capacity=8)
    servers = []
    for pool in (64, cfg.pos_pool):
        servers.append((RefServer(params, cfg, pos_pool=pool, **kw),
                        BatchServer(np_params, pcfg, device="cpu", pos_pool=pool, **kw)))
    docs = {"g": [list(rng.integers(0, cfg.vocab, 7)), 0],
            "d": [list(rng.integers(0, cfg.vocab, 8)), 0],
            "h": [list(rng.integers(0, cfg.vocab, 8)), 1]}
    for did, (toks, si) in docs.items():
        for srv in servers[si]:
            srv.open_document(did, toks)
            srv.submit_suggest(did, N_NEW)
    oracle = SuggestionEngine(tp, pcfg)
    oracle_eng = JitIncrementalEngine(np_params, pcfg, edit_capacity=4, row_capacity=16,
                                      device="cpu")
    for i in range(6):
        for did, (ref_toks, si) in docs.items():
            if did == "d":
                e = ("insert", 3, int(rng.integers(cfg.vocab)))
            elif did == "h":
                e = ("insert", len(ref_toks), int(rng.integers(cfg.vocab)))
            else:
                kind = rng.choice(["replace", "insert", "delete"], p=[0.4, 0.4, 0.2])
                if kind == "delete" and len(ref_toks) <= 2:
                    kind = "replace"
                p = int(rng.integers(len(ref_toks) + (kind == "insert")))
                e = (str(kind), p, int(rng.integers(cfg.vocab)))
            if e[0] == "insert":
                ref_toks.insert(e[1], e[2])
            elif e[0] == "delete":
                del ref_toks[e[1]]
            else:
                ref_toks[e[1]] = e[2]
            ref, ours = servers[si]
            for srv in (ref, ours):
                _edit(srv, did, e)
                assert srv.suggestion(did) is None  # a newer edit staled it
            got, want_ref = ours.suggest(did, N_NEW), ref.suggest(did, N_NEW)
            np.testing.assert_array_equal(got, want_ref, err_msg=f"{did} edit {i}")
            assert list(ours.tokens(did)) == ref_toks
            doc = ours.docs[did]
            want = oracle_suggestion(tp, pcfg, oracle_eng, doc.tokens, doc.positions,
                                     doc.valid, N_NEW, suggester=oracle)
            np.testing.assert_array_equal(got, want, err_msg=f"{did} edit {i}")
            np.testing.assert_array_equal(ours.suggestion(did), got)
    for ref, ours in servers:
        for name in SUGGEST_COUNTERS:
            assert getattr(ours.stats, name) == getattr(ref.stats, name), name
        assert dataclasses.asdict(ours.suggest_stats) == dataclasses.asdict(ref.suggest_stats)
        assert ours.stats.suggest_latency.count == ours.stats.suggest_refreshes
    tiny, big = servers[0][1], servers[1][1]
    assert tiny.stats.grows >= 1 and tiny.stats.defrags >= 1
    assert big.docs["h"].allocator.defrag_count >= 1  # the headroom path
    assert big.stats.suggest_headroom_defrags >= 1
    assert big.stats.defrags == big.docs["h"].allocator.defrag_count
    assert tiny.suggest_stats.prefill_rows_reused > 0
    # bytes_suggest counts every live decode cache, and close releases it
    assert tiny.stats.bytes_suggest == sum(tiny.suggester.cache_nbytes(d) for d in ("g", "d"))
    tiny.close_document("g")
    assert tiny.stats.bytes_suggest == tiny.suggester.cache_nbytes("d")


def test_server_cached_hits_and_cancel(setup):
    cfg, params, np_params, _ = setup
    kw = dict(edit_capacity=4, row_capacity=16, min_doc_capacity=8, pos_pool=POOL)
    ref = RefServer(params, cfg, **kw)
    ours = BatchServer(np_params, port_smoke(), device="cpu", **kw)
    hits = []
    ours.on_suggest_token = lambda did, serial, tok: hits.append((did, serial, tok))
    for srv in (ref, ours):
        srv.open_document("a", [5, 9, 2, 7, 1, 3])
        a = srv.suggest("a", N_NEW)
        b = srv.suggest("a", N_NEW)  # nothing changed: served from the cache
        np.testing.assert_array_equal(a, b)
        srv.submit_suggest("a", 2)  # a shorter re-subscription: a cached hit
        srv.flush()
        np.testing.assert_array_equal(srv.suggestion("a"), a[:2])
        srv.cancel_suggest("a")
        assert srv.suggestion("a") is None
    for name in ("suggest_refreshes", "suggest_cached_hits"):
        assert getattr(ours.stats, name) == getattr(ref.stats, name), name
    assert ours.stats.suggest_refreshes == 1 and ours.stats.suggest_cached_hits == 2
    assert [t for _, _, t in hits] == [int(t) for t in a] and {s for _, s, _ in hits} == {1}


def _reuse_trace_pos(rng, kind, n, cursor, workload):
    """The edit positions of ``benchmarks/suggest_reuse.py:_edit_pos``."""
    if workload == "typing":
        return int(rng.integers(max(0, n - 8), n + (1 if kind == "insert" else 0)))
    if workload == "editing":
        if rng.random() < 0.3:
            cursor = int(rng.integers(n))
        else:
            cursor = int(np.clip(cursor + rng.integers(-3, 4), 0, n - 1))
        return min(cursor, n if kind == "insert" else n - 1)
    return int(rng.integers(n + (1 if kind == "insert" else 0)))


def test_suggest_reuse_trace_matches_reference_baseline():
    """The trace of ``benchmarks/suggest_reuse.py`` at its gate parameters
    (doc_len 48, 6 edits, n_new 4, seed 0) replayed on the port reuses and
    recomputes exactly the prefill rows of the reference's committed
    baseline (``results/BASELINE_suggest_reuse.json``)."""
    import jax

    from _torch_parity import params_to_numpy
    from repro.configs.vq_opt_125m import smoke_config
    from repro.models import transformer as RT

    cfg = smoke_config(vqt=True)
    np_params = params_to_numpy(jax.device_get(RT.init_params(jax.random.PRNGKey(0), cfg)))
    srv = BatchServer(np_params, port_smoke(), edit_capacity=4, row_capacity=32,
                      max_batch=4, min_doc_capacity=16, device="cpu")
    baseline = {"typing": (263, 20), "editing": (263, 23), "uniform": (167, 116)}
    for workload, want in baseline.items():
        rng = np.random.default_rng(0)
        ref = list(rng.integers(0, cfg.vocab, 48))
        srv.open_document(workload, ref)
        srv.suggest(workload, 4)
        st = srv.suggest_stats
        rows0 = (st.prefill_rows_reused, st.prefill_rows_recomputed)
        cursor = 47
        for _ in range(6):
            kind = str(rng.choice(["replace", "insert", "delete"], p=[0.7, 0.2, 0.1]))
            n = len(ref)
            if kind == "delete" and n <= 2:
                kind = "replace"
            pos = cursor = _reuse_trace_pos(rng, kind, n, cursor, workload)
            tok = int(rng.integers(cfg.vocab))
            _edit(srv, workload, (kind, pos, tok))
            if kind == "insert":
                ref.insert(pos, tok)
            elif kind == "delete":
                del ref[pos]
            srv.suggest(workload, 4)
        got = (st.prefill_rows_reused - rows0[0], st.prefill_rows_recomputed - rows0[1])
        assert got == want, workload
