"""The port's tiered state store: the nine tests of
``tests/test_state_store.py`` on ``repro_torch``, and the port against the
reference under the same budgets and stream — the same tier after every
step and equal eviction, spill and rehydration counters.

The contract: device state is a pure function of its snapshot, so a
document evicted to host RAM (warm) or disk (cold) and touched again is
bit-exact against one that never left the device; suggestion decode caches
are soft state; ``close_document`` is the inverse of ``open_document``."""
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_parity import smoke_params  # noqa: E402
from repro.serving.batch_server import BatchServer as RefServer  # noqa: E402
from repro_torch.configs.vq_opt_125m import smoke_config as port_smoke  # noqa: E402
from repro_torch.serving.batch_server import BatchServer  # noqa: E402
from repro_torch.serving.jit_engine import (  # noqa: E402
    state_from_host, state_nbytes, state_nbytes_for, state_to_host,
)
from repro_torch.serving.state_store import DeviceBudgetError  # noqa: E402

DOC_LEN = 12
N_CAP = 16  # the capacity class of DOC_LEN with min_doc_capacity=16
SERVER = dict(edit_capacity=4, row_capacity=32, max_batch=2, min_doc_capacity=16)


@pytest.fixture(scope="module")
def setup():
    return smoke_params()


def _server(setup, **kw):
    return BatchServer(setup[2], port_smoke(), **{**SERVER, **kw}, device="cpu")


def _open_docs(srv, n_docs, seed=0, doc_len=DOC_LEN):
    rng = np.random.default_rng(seed)
    docs = {f"d{i}": list(rng.integers(0, srv.cfg.vocab, doc_len)) for i in range(n_docs)}
    srv.open_documents({d: list(t) for d, t in docs.items()})
    return docs


def _doc_bytes(srv):
    eng = srv.engine(srv.C, srv.R)
    return state_nbytes_for(N_CAP, eng.L, eng.meta)


def _reconcile(srv):
    """Recount every byte/doc stat from the underlying objects; the
    store-kept counters must match exactly."""
    s = srv.stats
    tiers = srv.store.tiers()
    assert set(tiers) == set(srv.docs)
    hot = [d for d, t in tiers.items() if t == "hot"]
    warm = [d for d, t in tiers.items() if t == "warm"]
    cold = [d for d, t in tiers.items() if t == "cold"]
    assert (s.docs_hot, s.docs_warm, s.docs_cold) == (len(hot), len(warm), len(cold))
    assert s.bytes_hot == sum(state_nbytes(srv.docs[d].state) for d in hot)
    for d in hot:
        assert srv.docs[d].state is not None
    for d in warm + cold:
        assert srv.docs[d].state is None
    assert s.bytes_warm == sum(srv.store.nbytes(d) for d in warm)
    assert s.bytes_cold == sum(srv.store.nbytes(d) for d in cold)
    if srv._sugg is not None:
        assert s.bytes_suggest == sum(srv._sugg.cache_nbytes(k) for k in srv._sugg.cached_keys())
    else:
        assert s.bytes_suggest == 0
    assert s.state_touches == s.hot_hits + s.rehydrations + s.rollback_rebuilds


# ---------------------------------------------------------------- accounting


def test_state_nbytes_formula_matches(setup):
    srv = _server(setup)
    _open_docs(srv, 1)
    doc = srv.docs["d0"]
    eng = srv.engine(srv.C, srv.R)
    assert state_nbytes(doc.state) == state_nbytes_for(doc.n_cap, eng.L, eng.meta)
    _reconcile(srv)


def test_stats_reconcile(setup, tmp_path):
    """Byte/doc counters reconcile after every kind of movement: ingest,
    edits, suggestion caches, forced warm and cold evictions, rehydration,
    grow, close."""
    srv = _server(setup, spill_dir=str(tmp_path))
    _open_docs(srv, 3)
    _reconcile(srv)
    srv.submit_replace("d0", 2, 5)
    srv.submit_insert("d1", 0, 9)
    srv.flush()
    _reconcile(srv)
    srv.suggest("d0", 4)
    srv.suggest("d1", 4)
    _reconcile(srv)
    assert srv.stats.bytes_suggest > 0
    srv.evict("d0", "warm")
    _reconcile(srv)
    assert srv.stats.evictions == 1
    srv.evict("d1", "cold")
    _reconcile(srv)
    assert srv.stats.spills == 1 and srv.stats.bytes_cold > 0
    srv.submit_replace("d1", 1, 3)  # cold doc: the next dispatch rehydrates
    srv.flush()
    _reconcile(srv)
    assert srv.tier("d1") == "hot" and srv.stats.rehydrations >= 1
    before = srv.store.nbytes("d2")
    for _ in range(N_CAP):
        srv.submit_insert("d2", 0, 1)
    srv.flush()
    eng = srv.engine(srv.C, srv.R)
    assert srv.stats.grows >= 1
    assert srv.store.nbytes("d2") == state_nbytes_for(
        srv.docs["d2"].n_cap, eng.L, eng.meta) > before
    _reconcile(srv)
    for d in ("d0", "d1", "d2"):
        srv.close_document(d)
    _reconcile(srv)
    assert srv.stats.bytes_hot == srv.stats.bytes_warm == \
        srv.stats.bytes_cold == srv.stats.bytes_suggest == 0


def test_close_document_no_leak(setup):
    """open -> edit -> suggest -> close in a loop grows nothing, and a
    long-lived bystander's allocator and slot map are untouched."""
    srv = _server(setup)
    _open_docs(srv, 1, seed=7)
    srv.suggest("d0", 4)
    base = srv.docs["d0"]
    base_alloc = base.allocator.snapshot().copy()
    base_free = list(base.free)
    baseline = (srv.stats.bytes_hot, len(srv.docs), len(srv.suggester.cached_keys()))
    rng = np.random.default_rng(3)
    for i in range(4):
        did = f"churn{i}"
        srv.open_document(did, list(rng.integers(0, srv.cfg.vocab, DOC_LEN)))
        srv.submit_insert(did, 0, 2)
        srv.submit_replace(did, 3, 4)
        srv.submit_delete(did, 1)
        srv.flush()
        srv.suggest(did, 4)
        srv.close_document(did)
        assert (srv.stats.bytes_hot, len(srv.docs),
                len(srv.suggester.cached_keys())) == baseline
        assert did not in srv.store
        _reconcile(srv)
    assert srv.stats.closes == 4
    np.testing.assert_array_equal(base.allocator.snapshot(), base_alloc)
    assert list(base.free) == base_free
    with pytest.raises(KeyError):
        srv.close_document("churn0")


# ---------------------------------------------------------------- residency


def test_rehydration_is_bit_exact(setup, tmp_path):
    """Warm and cold round trips reproduce logits and state leaves bit for
    bit; spill files are removed on rehydration."""
    srv = _server(setup, spill_dir=str(tmp_path))
    _open_docs(srv, 2, seed=1)
    srv.submit_insert("d0", 2, 11)
    srv.flush()
    ref_logits = srv.logits("d0")
    ref_state = state_to_host(srv.docs["d0"].state)
    for tier in ("warm", "cold"):
        srv.evict("d0", tier)
        assert srv.tier("d0") == tier and srv.docs["d0"].state is None
        got = srv.logits("d0")
        assert srv.tier("d0") == "hot"
        np.testing.assert_array_equal(got, ref_logits)
        for a, b in zip(state_to_host(srv.docs["d0"].state), ref_state):
            np.testing.assert_array_equal(a, b)
    assert os.listdir(str(tmp_path)) == []


def test_state_host_roundtrip_helpers(setup):
    srv = _server(setup)
    _open_docs(srv, 1, seed=2)
    state = srv.docs["d0"].state
    host = state_to_host(state)
    assert all(isinstance(leaf, np.ndarray) for leaf in host)
    back = state_from_host(host, "cpu")
    for a, b in zip(state, back):
        assert torch.equal(a, b) and a.dtype == b.dtype
        assert a.data_ptr() != b.data_ptr()  # a copy, never an alias
    assert sum(leaf.nbytes for leaf in host) == state_nbytes(state)


def test_budget_evicts_lru_and_pins_hold(setup):
    """A device budget of ~2 documents: opening a third evicts the least
    recently touched; a pinned document survives; pinning everything makes
    the next admission fail loudly."""
    srv = _server(setup)
    _open_docs(srv, 1)
    per = _doc_bytes(srv)
    srv2 = _server(setup, device_budget_bytes=int(2.4 * per), max_batch=1)
    _open_docs(srv2, 2, seed=4)
    assert srv2.stats.evictions == 0
    srv2.pin("d1")
    srv2.open_document("d2", list(np.arange(DOC_LEN) % srv2.cfg.vocab))
    assert srv2.tier("d0") == "warm"
    assert srv2.tier("d1") == "hot" and srv2.tier("d2") == "hot"
    _reconcile(srv2)
    srv2.pin("d2")
    with pytest.raises(DeviceBudgetError):
        srv2.open_document("d3", list(np.arange(DOC_LEN) % srv2.cfg.vocab))
    assert "d3" not in srv2.docs
    srv2.unpin("d1")
    srv2.open_document("d3", list(np.arange(DOC_LEN) % srv2.cfg.vocab))
    assert srv2.tier("d1") == "warm" and srv2.tier("d3") == "hot"
    _reconcile(srv2)
    srv2.submit_replace("d0", 0, 1)
    srv2.submit_replace("d1", 0, 1)
    srv2.flush()
    assert srv2.stats.rehydrations >= 2
    _reconcile(srv2)


def test_suggest_cache_is_soft_state(setup):
    """Decode caches are dropped before any document state is evicted, and
    a dropped cache changes nothing token-level."""
    srv = _server(setup)
    _open_docs(srv, 1, seed=5)
    want = srv.suggest("d0", 4)
    assert srv.suggester.cache_nbytes("d0") > 0
    srv.store._drop_suggest("d0")
    assert srv.suggester.cache_nbytes("d0") == 0
    assert srv.stats.bytes_suggest == 0
    srv.docs["d0"].suggest_fresh = False  # force a refresh without the cache
    np.testing.assert_array_equal(srv.suggest("d0", 4), want)
    _reconcile(srv)


def test_failed_dispatch_on_evicted_doc_rolls_back_to_void(setup):
    """A document enters a take evicted, the take's grow consumes its warm
    copy, then the dispatch fails: rollback lands it in 'void' without
    raising, and the next touch rebuilds it from the restored mirrors —
    tokens and logits bitwise those of a server that never failed."""
    toks = list(np.arange(N_CAP) % 512)  # fills n_cap: the insert grows
    oracle = _server(setup)
    oracle.open_document("d", list(toks))
    oracle.submit_insert("d", 0, 3)
    oracle.flush()

    srv = _server(setup)
    srv.open_document("d", list(toks))
    srv.evict("d", "warm")
    srv.submit_insert("d", 0, 3)
    eng = srv.engine(srv.C, srv.docs["d"].row_capacity)

    def failing(*a, **k):
        raise RuntimeError("injected dispatch failure")

    eng.batch_apply_inserts = failing
    try:
        with pytest.raises(RuntimeError, match="injected"):
            srv.step()
    finally:
        del eng.batch_apply_inserts
    assert srv.tier("d") == "void" and srv.docs["d"].state is None
    assert list(srv.docs["d"].pending) == [("insert", 0, 3)]
    np.testing.assert_array_equal(srv.docs["d"].seq_tokens(), toks)
    assert srv.store.ensure_hot(srv.docs["d"]) is not None
    assert srv.tier("d") == "hot" and srv.stats.rollback_rebuilds == 1
    srv.flush()
    np.testing.assert_array_equal(srv.tokens("d"), oracle.tokens("d"))
    np.testing.assert_array_equal(srv.logits("d"), oracle.logits("d"))
    _reconcile(srv)


# ------------------------------------------------------ differential churn


def _churn(srvs, n_docs, steps=10, seed=9, suggest_every=3):
    """The reference test's mixed edit + suggest stream with forced warm and
    cold evictions of another document between edits, fed to every server
    of ``srvs`` alike; yields after each step."""
    vocab = srvs[0].cfg.vocab
    refs = {d: list(srvs[0].docs[d].seq_tokens()) for d in srvs[0].docs}
    rng = np.random.default_rng(seed)
    forced = ["warm", "cold"]
    for t in range(steps):
        did = f"d{int(rng.integers(n_docs))}"
        n = len(refs[did])
        op = ["replace", "insert", "delete"][int(rng.integers(3))]
        if op == "delete" and n <= 2:
            op = "replace"
        if op == "replace":
            pos, tok = int(rng.integers(n)), int(rng.integers(vocab))
            refs[did][pos] = tok
            args = (did, pos, tok)
        elif op == "insert":
            pos, tok = int(rng.integers(n + 1)), int(rng.integers(vocab))
            refs[did].insert(pos, tok)
            args = (did, pos, tok)
        else:
            pos = int(rng.integers(n))
            del refs[did][pos]
            args = (did, pos)
        victim = f"d{(int(did[1:]) + 1 + t % (n_docs - 1)) % n_docs}"
        for srv in srvs:
            getattr(srv, f"submit_{op}")(*args)
            if srv.tier(victim) == "hot" and srv.store.device_budget_bytes is not None:
                srv.evict(victim, forced[t % 2])
            srv.flush()
        yield t, did, refs


def test_tiered_churn_matches_unbounded_oracle(setup, tmp_path):
    """More documents than the device budget admits, with forced warm AND
    cold evictions between edits: logits bit-identical and suggestions
    token-identical to an unbounded server, and closing leaks nothing."""
    probe = _server(setup)
    _open_docs(probe, 1)
    per = _doc_bytes(probe)
    spill = str(tmp_path / "spill")
    srv = _server(setup, device_budget_bytes=int(2.6 * per),
                  host_budget_bytes=int(1.2 * per), spill_dir=spill)
    oracle = _server(setup)
    n_docs = 4
    _open_docs(srv, n_docs, seed=6)
    _open_docs(oracle, n_docs, seed=6)
    assert srv.stats.evictions > 0, "the budget must force evictions at open"
    for t, did, refs in _churn([srv, oracle], n_docs):
        np.testing.assert_array_equal(srv.tokens(did), refs[did])
        np.testing.assert_array_equal(srv.logits(did), oracle.logits(did))
        if t % 3 == 0:
            np.testing.assert_array_equal(srv.suggest(did, 4), oracle.suggest(did, 4))
        _reconcile(srv)
    st = srv.stats
    assert st.evictions > 0 and st.spills > 0 and st.rehydrations > 0
    assert st.hot_hit_rate < 1.0
    assert oracle.stats.evictions == oracle.stats.rehydrations == 0
    for did in refs:
        np.testing.assert_array_equal(srv.tokens(did), refs[did])
        np.testing.assert_array_equal(srv.logits(did), oracle.logits(did))
    for did in list(srv.docs):
        srv.close_document(did)
    assert len(srv.docs) == 0
    assert st.bytes_hot == st.bytes_warm == st.bytes_cold == st.bytes_suggest == 0
    assert srv._sugg is None or srv._sugg.cached_keys() == []
    assert not os.path.isdir(spill) or os.listdir(spill) == []


# ------------------------------------------------------ against the reference


def test_tier_sequence_and_counters_match_the_reference(setup, tmp_path):
    """The port's and the reference's servers under the same byte budgets
    and the same churn stream (suggestions included): the same tier for
    every document after every step, equal byte counts per tier, and equal
    eviction, spill and rehydration counters and hot-hit rate."""
    cfg, params, _ = setup
    port = _server(setup)
    _open_docs(port, 1)
    per = _doc_bytes(port)
    budgets = dict(device_budget_bytes=int(2.6 * per), host_budget_bytes=int(1.2 * per))
    ours = _server(setup, **budgets, spill_dir=str(tmp_path / "port"))
    ref = RefServer(params, cfg, **SERVER, **budgets, spill_dir=str(tmp_path / "ref"))
    n_docs = 4
    for srv in (ours, ref):
        _open_docs(srv, n_docs, seed=6)
    assert ours.store.tiers() == ref.store.tiers()
    fields = ("evictions", "spills", "rehydrations", "hot_hits", "state_touches",
              "bytes_hot", "bytes_warm", "bytes_cold", "bytes_suggest")
    for t, did, _ in _churn([ours, ref], n_docs):
        if t % 3 == 0:
            np.testing.assert_array_equal(ours.suggest(did, 4), ref.suggest(did, 4))
        assert ours.store.tiers() == ref.store.tiers(), f"step {t}"
        for name in fields:
            assert getattr(ours.stats, name) == getattr(ref.stats, name), (t, name)
    assert ours.stats.evictions > 0 and ours.stats.spills > 0
    assert ours.stats.hot_hit_rate == ref.stats.hot_hit_rate
