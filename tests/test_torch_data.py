"""The port's copies of ``repro/data`` against the reference: every seeded
corpus, batch, edit stream, revision pair and fleet schedule is equal."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.data import edit_stream as ref_es  # noqa: E402
from repro.data import synthetic as ref_syn  # noqa: E402
from repro_torch.data import edit_stream as port_es  # noqa: E402
from repro_torch.data import synthetic as port_syn  # noqa: E402

VOCAB = 512


def _edits(edits):
    return [(e.op, e.pos, e.token) for e in edits]


@pytest.mark.parametrize("seed", [0, 3])
def test_corpus_documents_equal(seed):
    ref, port = ref_syn.SyntheticCorpus(VOCAB, seed=seed), port_syn.SyntheticCorpus(VOCAB, seed=seed)
    for length, doc_seed in ((1, 0), (48, 7), (200, 12345)):
        np.testing.assert_array_equal(port.document(length, doc_seed),
                                      ref.document(length, doc_seed))
    for doc_seed in (0, 5):
        (d_p, l_p), (d_r, l_r) = port.classification_doc(40, doc_seed), ref.classification_doc(40, doc_seed)
        np.testing.assert_array_equal(d_p, d_r)
        assert l_p == l_r


@pytest.mark.parametrize("pos_pool", [None, 1000])
def test_lm_batches_equal(pos_pool):
    kw = dict(batch=3, seq_len=16, steps=3, seed=2, pos_pool=pos_pool)
    got = list(port_syn.lm_batches(port_syn.SyntheticCorpus(VOCAB), **kw))
    want = list(ref_syn.lm_batches(ref_syn.SyntheticCorpus(VOCAB), **kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
            assert g[k].dtype == w[k].dtype


def test_edit_stream_equal():
    port = port_es.EditStream(port_syn.SyntheticCorpus(VOCAB), doc_len=40, seed=4)
    ref = ref_es.EditStream(ref_syn.SyntheticCorpus(VOCAB), doc_len=40, seed=4)
    for i in range(3):
        np.testing.assert_array_equal(port.base_document(i), ref.base_document(i))
        assert _edits(port.atomic_edits(i, 12)) == _edits(ref.atomic_edits(i, 12))
        (po, pn), (ro, rn) = port.revision(i, 0.1), ref.revision(i, 0.1)
        np.testing.assert_array_equal(po, ro)
        np.testing.assert_array_equal(pn, rn)


def test_revision_pairs_equal():
    port = port_es.EditStream(port_syn.SyntheticCorpus(VOCAB), doc_len=64, seed=1)
    ref = ref_es.EditStream(ref_syn.SyntheticCorpus(VOCAB), doc_len=64, seed=1)
    got = list(port_es.revision_pairs(port, 4))
    want = list(ref_es.revision_pairs(ref, 4))
    for (po, pn, ps, pf), (ro, rn, rs, rf) in zip(got, want, strict=True):
        np.testing.assert_array_equal(po, ro)
        np.testing.assert_array_equal(pn, rn)
        assert _edits(ps) == _edits(rs) and pf == rf


@pytest.mark.parametrize("seed", [0, 9])
def test_traffic_generator_equal(seed):
    kw = dict(vocab=VOCAB, n_docs=5, doc_len=24, seed=seed)
    port, ref = port_es.TrafficGenerator(**kw), ref_es.TrafficGenerator(**kw)
    np.testing.assert_array_equal(port.popularity, ref.popularity)
    for idx in range(3):
        r_p, r_r = port.base_document(idx), ref.base_document(idx)
        assert r_p == r_r
        assert port.session_ops(idx, 17, r_p) == ref.session_ops(idx, 17, r_r)
        assert r_p == r_r  # both mutated their reference the same way
    got_ev, got_refs = port.fleet_events(12)
    want_ev, want_refs = ref.fleet_events(12)
    assert got_ev == want_ev and got_refs == want_refs
