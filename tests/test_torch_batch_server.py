"""The port's ``BatchServer`` against the reference's on one seeded mixed
stream that forces a grow, a defrag and an overflow fallback: equal
tokens, equal codes, logits within 3e-4, equal slow-path counters — and
the failed-dispatch rollback."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_parity import smoke_params  # noqa: E402
from repro.serving.batch_server import BatchServer as RefServer  # noqa: E402
from repro_torch.configs.vq_opt_125m import smoke_config as port_smoke  # noqa: E402
from repro_torch.core.edits import Edit, apply_edits  # noqa: E402
from repro_torch.serving.batch_server import BatchServer  # noqa: E402

SERVER = dict(edit_capacity=4, row_capacity=8, max_batch=2, min_doc_capacity=8,
              pos_pool=256)
DOCS = {"a": [5, 9, 2, 7, 1, 3, 8, 4],  # fills its class: the first insert grows
        "b": [4, 4, 8, 1, 2, 6, 11, 3, 9, 10, 7, 2]}


@pytest.fixture(scope="module")
def setup():
    return smoke_params()


def _stream(vocab, seed=11, rounds=5, per_round=6):
    """Seeded rounds of (doc, Edit): ~50% replace / 30% insert / 20% delete,
    plus a burst of inserts at one position of "b" (gap exhaustion)."""
    rng = np.random.default_rng(seed)
    lens = {k: len(v) for k, v in DOCS.items()}
    out = []
    for r in range(rounds):
        batch = []
        for _ in range(per_round):
            did = ("a", "b")[int(rng.integers(2))]
            u = rng.random()
            if u < 0.5:
                e = Edit("replace", int(rng.integers(lens[did])), int(rng.integers(vocab)))
            elif u < 0.8 or lens[did] <= 3:
                e = Edit("insert", int(rng.integers(lens[did] + 1)), int(rng.integers(vocab)))
            else:
                e = Edit("delete", int(rng.integers(lens[did])))
            lens[did] += {"replace": 0, "insert": 1, "delete": -1}[e.op]
            batch.append((did, e))
        if r == 2:
            for _ in range(6):
                batch.append(("b", Edit("insert", 1, int(rng.integers(vocab)))))
                lens["b"] += 1
        out.append(batch)
    return out


def _serve(srv, stream):
    srv.open_documents({k: list(v) for k, v in DOCS.items()})
    for batch in stream:
        for did, e in batch:
            srv.submit_edit(did, e)
        srv.flush()


def test_server_matches_reference_stream(setup):
    cfg, params, np_params = setup
    stream = _stream(cfg.vocab)
    ref = RefServer(params, cfg, **SERVER)
    ours = BatchServer(np_params, port_smoke(), device="cpu", **SERVER)
    _serve(ref, stream)
    _serve(ours, stream)
    for name in ("grows", "defrags", "overflows", "device_grows",
                 "device_defrags", "full_forwards", "batch_steps",
                 "edits_applied", "traced_shapes"):
        assert getattr(ours.stats, name) == getattr(ref.stats, name), name
    assert ours.stats.grows >= 1 and ours.stats.defrags >= 1
    assert ours.stats.overflows >= 1
    for did, toks in DOCS.items():
        replay = apply_edits(toks, [e for batch in stream for d, e in batch if d == did])
        np.testing.assert_array_equal(ours.tokens(did), replay)
        np.testing.assert_array_equal(ours.tokens(did), ref.tokens(did))
        np.testing.assert_array_equal(ours.state(did).codes.numpy(),
                                      np.asarray(ref.state(did).codes))
        np.testing.assert_allclose(ours.logits(did), np.asarray(ref.logits(did)),
                                   atol=3e-4)
    assert ours.stats.bytes_hot == sum(
        sum(t.numel() * t.element_size() for t in d.state) for d in ours.docs.values())
    assert ours.tier("a") == "hot" and ours.stats.docs_hot == 2
    ours.close_document("a")
    assert ours.stats.docs_hot == 1 and ours.stats.closes == 1
    assert ours.stats.bytes_hot == sum(t.numel() * t.element_size()
                                       for t in ours.docs["b"].state)
    with pytest.raises(KeyError):
        ours.tier("a")


def test_inline_path_matches_fused_path(setup):
    cfg, _, np_params = setup
    stream = _stream(cfg.vocab, seed=12)
    fused = BatchServer(np_params, port_smoke(), device="cpu", **SERVER)
    inline = BatchServer(np_params, port_smoke(), device="cpu",
                         use_fused_kernel=False, **SERVER)
    _serve(fused, stream)
    _serve(inline, stream)
    for name in ("grows", "defrags", "overflows"):
        assert getattr(fused.stats, name) == getattr(inline.stats, name), name
    for did in DOCS:
        np.testing.assert_array_equal(fused.tokens(did), inline.tokens(did))
        assert torch.equal(fused.state(did).codes, inline.state(did).codes)
        np.testing.assert_allclose(fused.logits(did), inline.logits(did), atol=1e-3)


def test_failed_dispatch_rolls_back(setup):
    """An injected dispatch failure after a take that grew the document
    restores the pre-take mirrors and device state; the retry converges to
    the never-failed server's tokens and logits."""
    cfg, _, np_params = setup
    toks = DOCS["a"]
    oracle = BatchServer(np_params, port_smoke(), device="cpu", **SERVER)
    oracle.open_document("d", list(toks))
    oracle.submit_insert("d", 0, 7)
    oracle.flush()

    srv = BatchServer(np_params, port_smoke(), device="cpu", **SERVER)
    srv.open_document("d", list(toks))
    pre_cap, pre_state = srv.docs["d"].n_cap, srv.docs["d"].state
    srv.submit_insert("d", 0, 7)
    eng = srv.engine(srv.C, srv.docs["d"].row_capacity)
    orig = eng.batch_apply_inserts
    eng.batch_apply_inserts = lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("injected dispatch failure"))
    try:
        with pytest.raises(RuntimeError, match="injected"):
            srv.step()
    finally:
        eng.batch_apply_inserts = orig
    doc = srv.docs["d"]
    assert doc.n_cap == pre_cap and doc.state is pre_state
    assert list(doc.pending) == [("insert", 0, 7)]
    np.testing.assert_array_equal(doc.seq_tokens(), toks)
    srv.flush()
    assert srv.stats.device_grows >= 1
    np.testing.assert_array_equal(srv.tokens("d"), oracle.tokens("d"))
    np.testing.assert_allclose(srv.logits("d"), oracle.logits("d"), atol=3e-4)
