"""The port's op-counting ``IncrementalServer`` (``repro_torch.serving.
engine``) against the JAX package's on the smoke config's weights, on the
CPU: the same ``ServerStats`` (requests, edits, defrags, incremental and
dense-equivalent ops) request by request, the same tokens and position ids,
logits within 2e-4 — and the reference's own ``tests/test_serving.py``
cases hold for the port."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import smoke_params  # noqa: E402
from repro.core import edits as redits  # noqa: E402
from repro.serving.engine import IncrementalServer as RefServer  # noqa: E402
from repro_torch.configs.vq_opt_125m import smoke_config  # noqa: E402
from repro_torch.core.edits import Edit, apply_edit  # noqa: E402
from repro_torch.serving import IncrementalServer, ServerStats  # noqa: E402


@pytest.fixture(scope="module")
def weights():
    cfg_ref, params, np_params = smoke_params()
    return cfg_ref, params, np_params


def _pair(weights, **kw):
    cfg_ref, params, np_params = weights
    return (RefServer(params, cfg_ref, **kw),
            IncrementalServer(np_params, smoke_config(), device="cpu", **kw))


def _assert_same(ref, srv, doc_id):
    assert dataclasses.asdict(srv.stats) == dataclasses.asdict(ref.stats)
    assert srv.stats.speedup == ref.stats.speedup
    assert list(srv.tokens(doc_id)) == list(ref.tokens(doc_id))
    assert srv.docs[doc_id].allocator.positions == ref.docs[doc_id].allocator.positions
    np.testing.assert_allclose(srv.logits(doc_id), ref.logits(doc_id), atol=2e-4)
    assert srv.counter.summary() == ref.counter.summary()


def test_lazy_exports():
    assert ServerStats().speedup == 0.0
    assert IncrementalServer.__module__ == "repro_torch.serving.engine"


@pytest.mark.parametrize("seed", [0, 1])
def test_online_edits_stay_consistent(weights, seed):
    """The reference's online case, request by request against it."""
    ref, srv = _pair(weights)
    cfg = srv.cfg
    doc = [int(t) for t in np.random.default_rng(seed).integers(0, cfg.vocab, 40)]
    ref.open_document("a", doc)
    srv.open_document("a", doc)
    _assert_same(ref, srv, "a")
    edits = [Edit("replace", 5, 7), Edit("insert", 11, 9), Edit("delete", 0),
             Edit("insert", 39, 3), Edit("replace", 20, 1)]
    expect = list(doc)
    for e in edits:
        assert srv.apply_edit("a", e) == ref.apply_edit("a", redits.Edit(e.op, e.pos, e.token))
        expect = apply_edit(expect, e)
        _assert_same(ref, srv, "a")
    assert list(srv.tokens("a")) == expect
    # the state equals recomputing from scratch with the server's positions
    fresh = srv.engine.full_forward(expect, srv.docs["a"].allocator.positions)
    np.testing.assert_allclose(srv.docs["a"].state.xs[-1].numpy(),
                               fresh.xs[-1].numpy(), atol=5e-5)


def test_offline_revision_and_speedup(weights):
    ref, srv = _pair(weights)
    cfg = srv.cfg
    doc = [int(t) for t in np.random.default_rng(1).integers(0, cfg.vocab, 64)]
    new = list(doc)
    new[10] = 3
    new[30] = 4
    del new[50]
    new.insert(20, 8)
    for s in (ref, srv):
        s.open_document("b", doc)
    ops = srv.submit_revision("b", new)
    assert ops == ref.submit_revision("b", new)
    _assert_same(ref, srv, "b")
    assert list(srv.tokens("b")) == new
    assert ops < srv._dense_ops(len(new)), "incremental must beat from-scratch"
    assert srv.stats.edits == 4


def test_defrag_counted(weights):
    """A tiny position pool forces defragmentation under repeated inserts;
    the port counts the same defrags and the same ops as the reference."""
    ref, srv = _pair(weights, pos_pool=80)
    cfg = srv.cfg
    rng = np.random.default_rng(2)
    doc = [int(t) for t in rng.integers(0, cfg.vocab, 40)]
    ref.open_document("c", doc)
    srv.open_document("c", doc)
    for _ in range(30):
        tok = int(rng.integers(cfg.vocab))
        assert (srv.apply_edit("c", Edit("insert", 20, tok))
                == ref.apply_edit("c", redits.Edit("insert", 20, tok)))
    _assert_same(ref, srv, "c")
    assert srv.stats.defrags >= 1
    assert len(srv.tokens("c")) == 70


def test_revision_defrag_counted(weights):
    """A revision that outgrows its gap re-spreads every id through the
    allocator and is counted as a full forward, as in the reference."""
    ref, srv = _pair(weights, pos_pool=48)
    cfg = srv.cfg
    doc = [int(t) for t in np.random.default_rng(3).integers(0, cfg.vocab, 40)]
    new = doc[:10] + [1, 2, 3, 4, 5] + doc[10:]
    for s in (ref, srv):
        s.open_document("r", doc)
    assert srv.submit_revision("r", new) == ref.submit_revision("r", new)
    _assert_same(ref, srv, "r")
    assert srv.docs["r"].allocator.defrag_count == ref.docs["r"].allocator.defrag_count == 1
