"""The port's deadline-batching async front end: the concurrency tests of
``tests/test_async_server.py`` on ``repro_torch`` (any interleaving of
client threads equals a sequential ``BatchServer`` fed each document's
requests in order; both dispatch triggers; grow and defrag mid-stream;
streaming; failure isolation), and token equality with the reference's
``AsyncBatchServer`` on the same per-document requests."""
import threading

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_parity import smoke_params  # noqa: E402
from repro.serving.async_server import AsyncBatchServer as RefAsync  # noqa: E402
from repro.serving.batch_server import BatchServer as RefServer  # noqa: E402
from repro_torch.configs.vq_opt_125m import smoke_config as port_smoke  # noqa: E402
from repro_torch.serving.async_server import AsyncBatchServer  # noqa: E402
from repro_torch.serving.batch_server import BatchServer  # noqa: E402
from repro_torch.serving.suggest import SuggestionEngine, oracle_suggestion  # noqa: E402

N_NEW = 4
WAIT = 300.0
SERVER = dict(edit_capacity=4, row_capacity=16, max_batch=4, min_doc_capacity=16)


@pytest.fixture(scope="module")
def setup():
    cfg, params, np_params = smoke_params()
    return cfg, params, np_params, {}


def _server(setup, **kw):
    return BatchServer(setup[2], port_smoke(), **{**SERVER, **kw}, device="cpu")


def _oracle(setup, srv, doc_id):
    cache = setup[3]
    if "sugg" not in cache:
        cache["sugg"] = SuggestionEngine(srv.suggester.params, srv.cfg)
    doc = srv.docs[doc_id]
    return oracle_suggestion(srv.suggester.params, srv.cfg, srv.engine(srv.C, srv.R),
                             doc.tokens, doc.positions, doc.valid, N_NEW,
                             suggester=cache["sugg"])


def test_back_to_back_suggest_no_redispatch(setup):
    """Unchanged watermarks: ``suggest`` serves the cached continuation
    without re-entering the prefill/dispatch path."""
    srv = _server(setup)
    rng = np.random.default_rng(3)
    srv.open_document("d", list(rng.integers(0, srv.cfg.vocab, 12)))
    first = srv.suggest("d", N_NEW)
    before = (srv.stats.batch_steps, srv.stats.full_forwards, srv.stats.suggest_refreshes,
              srv.suggest_stats.refreshes, srv.suggest_stats.decode_steps)
    hits0 = srv.stats.suggest_cached_hits
    np.testing.assert_array_equal(srv.suggest("d", N_NEW), first)
    np.testing.assert_array_equal(srv.suggest("d", 2), first[:2])
    after = (srv.stats.batch_steps, srv.stats.full_forwards, srv.stats.suggest_refreshes,
             srv.suggest_stats.refreshes, srv.suggest_stats.decode_steps)
    assert after == before, "a cached suggest re-entered the dispatch path"
    assert srv.stats.suggest_cached_hits == hits0 + 2
    srv.submit_replace("d", 2, int(rng.integers(srv.cfg.vocab)))
    refreshed = srv.suggest("d", N_NEW)
    assert srv.suggest_stats.refreshes == before[3] + 1
    np.testing.assert_array_equal(refreshed, _oracle(setup, srv, "d"))


def _bursts(vocab, init, seed, n_rounds=3):
    """Seeded edit bursts for one document, valid in order against ``init``
    (the stream is fixed per document however rounds interleave)."""
    rng = np.random.default_rng(seed)
    ref, out = list(init), []
    for _ in range(n_rounds):
        burst = []
        for _ in range(int(rng.integers(1, 4))):
            kind = str(rng.choice(["replace", "insert", "delete"], p=[0.6, 0.3, 0.1]))
            if kind == "delete" and len(ref) <= 6:
                kind = "replace"
            tok = int(rng.integers(vocab))
            if kind == "insert":
                pos = int(rng.integers(len(ref) + 1))
                ref.insert(pos, tok)
            elif kind == "delete":
                pos = int(rng.integers(len(ref)))
                del ref[pos]
            else:
                pos = int(rng.integers(len(ref)))
                ref[pos] = tok
            burst.append((kind, pos, tok))
        out.append(burst)
    return out, ref


def _submit(srv, did, kind, pos, tok):
    if kind == "delete":
        return srv.submit_delete(did, pos)
    return getattr(srv, f"submit_{kind}")(did, pos, tok)


def _run_clients(asrv, plans):
    """One thread per document: each burst, then a blocking suggestion."""
    got = {d: [] for d in plans}

    def client(did):
        for burst in plans[did]:
            for kind, pos, tok in burst:
                _submit(asrv, did, kind, pos, tok)
            got[did].append(asrv.suggest(did, N_NEW).result(WAIT))

    threads = [threading.Thread(target=client, args=(d,)) for d in plans]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return got


def test_concurrent_load_matches_sequential_oracle(setup):
    """Threads interleaving edits and suggestions through the async front
    end match a sequential BatchServer replay token-exactly, under forced
    deadline-expiry dispatch (bucket_docs too large to ever fill)."""
    srv = _server(setup)
    rng = np.random.default_rng(7)
    doc_ids = [f"c{i}" for i in range(3)]
    inits = {d: list(rng.integers(0, srv.cfg.vocab, 10 + 2 * i)) for i, d in enumerate(doc_ids)}
    plans, finals = {}, {}
    for i, d in enumerate(doc_ids):
        plans[d], finals[d] = _bursts(srv.cfg.vocab, inits[d], 100 + i)
    with AsyncBatchServer(srv, max_batch_delay_ms=5.0, bucket_docs=64) as asrv:
        for t in [asrv.open_document(d, inits[d]) for d in doc_ids]:
            t.result(WAIT)
        got = _run_clients(asrv, plans)
        final_tokens = {d: asrv.tokens(d).result(WAIT) for d in doc_ids}
        astats = asrv.stats
    assert astats.deadline_rounds > 0 and astats.full_rounds == 0
    assert astats.requests_failed == 0
    n_edits = sum(len(b) for d in doc_ids for b in plans[d])
    assert astats.admitted_edits == n_edits
    assert astats.admitted_suggests == sum(len(s) for s in got.values())
    seq = _server(setup)
    for d in doc_ids:
        seq.open_document(d, inits[d])
        for burst, sugg in zip(plans[d], got[d], strict=True):
            for kind, pos, tok in burst:
                _submit(seq, d, kind, pos, tok)
            np.testing.assert_array_equal(sugg, seq.suggest(d, N_NEW))
        np.testing.assert_array_equal(final_tokens[d], seq.tokens(d))
        assert list(final_tokens[d]) == finals[d]
    assert srv.stats.edit_latency.count == n_edits
    assert srv.stats.suggest_latency.count > 0
    for h in (srv.stats.edit_latency, srv.stats.suggest_latency):
        assert h.p50 <= h.p99 <= h.max_ms and h.mean_ms > 0


def test_bucket_full_dispatches_before_deadline(setup):
    """With an hour-long deadline, rounds still dispatch the moment
    ``bucket_docs`` distinct documents have admitted work."""
    srv = _server(setup)
    rng = np.random.default_rng(5)
    asrv = AsyncBatchServer(srv, max_batch_delay_ms=3_600_000.0, bucket_docs=2)
    try:
        for t in [asrv.open_document(d, list(rng.integers(0, srv.cfg.vocab, 8)))
                  for d in ("a", "b")]:
            t.result(WAIT)
        for t in [asrv.submit_replace(d, 1, int(rng.integers(srv.cfg.vocab)))
                  for d in ("a", "b")]:
            t.result(WAIT)
        assert asrv.stats.full_rounds >= 2 and asrv.stats.deadline_rounds == 0
    finally:
        asrv.close()
    np.testing.assert_array_equal(srv.suggest("a", N_NEW), _oracle(setup, srv, "a"))


def test_failed_request_does_not_stall_the_loop(setup):
    srv = _server(setup)
    rng = np.random.default_rng(9)
    with AsyncBatchServer(srv, max_batch_delay_ms=2.0) as asrv:
        bad = asrv.submit_replace("nope", 0, 1)
        good = asrv.open_document("ok", list(rng.integers(0, srv.cfg.vocab, 8)))
        with pytest.raises(KeyError):
            bad.result(WAIT)
        good.result(WAIT)
        out = asrv.suggest("ok", N_NEW).result(WAIT)
        assert asrv.stats.requests_failed == 1
    np.testing.assert_array_equal(out, _oracle(setup, srv, "ok"))


def test_opens_coalesce_into_one_round(setup):
    srv = _server(setup)
    rng = np.random.default_rng(2)
    with AsyncBatchServer(srv, max_batch_delay_ms=100.0, bucket_docs=64) as asrv:
        docs = {f"o{i}": list(rng.integers(0, srv.cfg.vocab, 9)) for i in range(3)}
        for t in [asrv.open_document(d, toks) for d, toks in docs.items()]:
            t.result(WAIT)
        assert asrv.stats.rounds == 1 and asrv.stats.admitted_opens == 3
        for d, toks in docs.items():
            assert list(asrv.tokens(d).result(WAIT)) == toks


@pytest.mark.parametrize("path", ["grow", "defrag"])
def test_async_reingest_paths_match_oracle(setup, path):
    """Inserts over a capacity-8 document force a grow; a 64-id position
    pool forces a defrag. The async path stays token-exact through both."""
    if path == "grow":
        srv, n0, at, n_ins, seed = _server(setup, min_doc_capacity=8), 7, None, 8, 11
    else:
        srv, n0, at, n_ins, seed = _server(setup, max_batch=2, pos_pool=64), 8, 3, 7, 13
    rng = np.random.default_rng(seed)
    ref = list(rng.integers(0, srv.cfg.vocab, n0))
    with AsyncBatchServer(srv, max_batch_delay_ms=3.0) as asrv:
        asrv.open_document("g", ref).result(WAIT)
        for i in range(n_ins):
            pos = int(rng.integers(len(ref) + 1)) if at is None else at
            tok = int(rng.integers(srv.cfg.vocab))
            asrv.submit_insert("g", pos, tok)
            ref.insert(pos, tok)
            got = asrv.suggest("g", N_NEW).result(WAIT)
            np.testing.assert_array_equal(got, _oracle(setup, srv, "g"), err_msg=f"insert {i}")
        assert list(asrv.tokens("g").result(WAIT)) == ref
    assert getattr(srv.stats, path + "s") >= 1


def test_subscription_streams_tokens_then_suggestions(setup):
    """Per-token events as the decode loop runs, then the completed
    continuation; token events reassemble into exactly the suggestion and
    serials strictly increase."""
    srv = _server(setup)
    rng = np.random.default_rng(17)
    ref = list(rng.integers(0, srv.cfg.vocab, 10))
    with AsyncBatchServer(srv, max_batch_delay_ms=3.0) as asrv:
        asrv.open_document("s", ref).result(WAIT)
        stream = asrv.subscribe("s", N_NEW)
        serial0, sugg0 = stream.next_suggestion(WAIT)
        np.testing.assert_array_equal(sugg0, _oracle(setup, srv, "s"))
        for _ in range(2):
            pos = int(rng.integers(len(ref)))
            tok = int(rng.integers(srv.cfg.vocab))
            asrv.submit_replace("s", pos, tok).result(WAIT)
            ref[pos] = tok
            asrv.flush(WAIT)
        np.testing.assert_array_equal(asrv.suggest("s", N_NEW).result(WAIT),
                                      _oracle(setup, srv, "s"))
        asrv.unsubscribe(stream)
    events, tokens, last_serial = [], {}, serial0
    while True:
        kind, serial, *rest = stream.get(timeout=1.0)
        if kind == "closed":
            break
        events.append((kind, serial, rest))
        if kind == "token":
            idx, tok = rest
            tokens.setdefault(serial, [])
            assert idx == len(tokens[serial]), "token events out of order"
            tokens[serial].append(tok)
        else:
            assert serial > last_serial or serial == serial0
            last_serial = max(last_serial, serial)
            assert tokens[serial] == list(rest[0])
    assert len([e for e in events if e[0] == "suggestion"]) >= 2
    assert srv.stats.suggest_latency.count > 0


def test_close_document_closes_streams(setup):
    srv = _server(setup)
    rng = np.random.default_rng(19)
    with AsyncBatchServer(srv, max_batch_delay_ms=3.0) as asrv:
        asrv.open_document("z", list(rng.integers(0, srv.cfg.vocab, 8))).result(WAIT)
        stream = asrv.subscribe("z", N_NEW)
        stream.next_suggestion(WAIT)
        asrv.close_document("z").result(WAIT)
        with pytest.raises(RuntimeError, match="closed"):
            stream.next_suggestion(5.0)
        assert "z" not in srv.docs


def test_tokens_match_the_reference_async_server(setup):
    """The same per-document requests through the reference's
    ``AsyncBatchServer`` and the port's: equal suggestions and final tokens."""
    cfg, params = setup[0], setup[1]
    rng = np.random.default_rng(23)
    inits = {f"p{i}": list(rng.integers(0, cfg.vocab, 9 + 3 * i)) for i in range(2)}
    plans = {d: _bursts(cfg.vocab, inits[d], 40 + i, n_rounds=2)[0]
             for i, d in enumerate(inits)}
    results = []
    for make in (lambda: (RefAsync, RefServer(params, cfg, **SERVER)),
                 lambda: (AsyncBatchServer, _server(setup))):
        cls, srv = make()
        with cls(srv, max_batch_delay_ms=5.0) as asrv:
            for t in [asrv.open_document(d, toks) for d, toks in inits.items()]:
                t.result(WAIT)
            got = _run_clients(asrv, plans)
            final = {d: list(asrv.tokens(d).result(WAIT)) for d in inits}
        results.append((got, final))
    (ref_got, ref_final), (got, final) = results
    assert final == ref_final
    for d in inits:
        for a, b in zip(got[d], ref_got[d], strict=True):
            np.testing.assert_array_equal(a, np.asarray(b))
