"""Serving-document checkpoints read in both packages: a snapshot or cold
spill written by the reference imports into the port (logits within the
reference's 3e-4, then the same tokens), a port snapshot reads in
``repro.checkpoint`` with the reference's keys, dtypes and shapes, and an
interrupted write never leaves a visible file."""
import os
import shutil

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_parity import smoke_params  # noqa: E402
from repro.checkpoint.store import restore_serving_document as ref_restore  # noqa: E402
from repro.serving.batch_server import BatchServer as RefServer  # noqa: E402
from repro.serving.state_store import cold_path_for as ref_cold_path  # noqa: E402
from repro_torch.checkpoint import store as port_store  # noqa: E402
from repro_torch.configs.vq_opt_125m import smoke_config as port_smoke  # noqa: E402
from repro_torch.serving.batch_server import BatchServer  # noqa: E402
from repro_torch.serving.jit_engine import state_to_host  # noqa: E402

SERVER = dict(edit_capacity=4, row_capacity=16, max_batch=2, min_doc_capacity=8,
              pos_pool=256)
DOCS = {"a": [5, 9, 2, 7, 1, 3, 8, 4], "b": [4, 4, 8, 1, 2, 6, 11, 3, 9, 10]}
EDITS = [("a", "insert", 3, 17), ("b", "replace", 2, 30), ("b", "delete", 5, 0),
         ("a", "replace", 0, 6)]
MORE = [("a", "insert", 1, 40), ("a", "delete", 4, 0), ("b", "insert", 0, 12)]


def _drive(srv, edits):
    for did, op, pos, tok in edits:
        if op == "delete":
            srv.submit_delete(did, pos)
        else:
            getattr(srv, f"submit_{op}")(did, pos, tok)
    srv.flush()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One reference server and one port server through the same edits,
    then every file both tests need, written at that point: the reference's
    snapshot of "a", its cold spill of "b" (copied before its rehydration
    removes it), the port's snapshot of "a". The reference then takes MORE
    (the values adopted documents must reach) and last adopts the port's
    snapshot of "a". One reference server keeps the jit compiles to one set."""
    cfg, params, np_params = smoke_params()
    tmp = tmp_path_factory.mktemp("ckpt")
    ref = RefServer(params, cfg, **SERVER, spill_dir=str(tmp / "cold"))
    port = BatchServer(np_params, port_smoke(), **SERVER, device="cpu")
    for srv in (ref, port):
        srv.open_documents({k: list(v) for k, v in DOCS.items()})
        _drive(srv, EDITS)
    paths = {"ref_a": str(tmp / "ref_a.npz"), "port_a": str(tmp / "port_a.npz"),
             "cold_b": str(tmp / "cold_b.npz")}
    ref.checkpoint_document("a", paths["ref_a"])
    port.checkpoint_document("a", paths["port_a"])
    assert ref.evict("b", "cold") == "cold"
    spilled = ref_cold_path(str(tmp / "cold"), "b")
    shutil.copy(spilled, paths["cold_b"])
    before = {d: np.asarray(ref.logits(d)) for d in DOCS}  # rehydrates "b"
    assert not os.path.exists(spilled)
    _drive(ref, MORE)
    after = {d: (np.asarray(ref.tokens(d)), np.asarray(ref.logits(d))) for d in DOCS}
    ref.close_document("a")
    shutil.copy(paths["port_a"], str(tmp / "port_a_copy.npz"))
    ref.import_document("a", str(tmp / "port_a_copy.npz"))
    return dict(port=port, paths=paths, before=before, after=after,
                ref_adopted=np.asarray(ref.logits("a")))


def _adopt_and_serve(world, did, path):
    """A fresh port server adopts ``did`` from ``path``, then takes MORE:
    logits within 3e-4 of the reference's before and after, equal tokens."""
    port = world["port"]
    srv = BatchServer(port._params, port.cfg, **SERVER, device="cpu")
    srv.import_document(did, path, remove=False)
    np.testing.assert_allclose(srv.logits(did), world["before"][did], atol=3e-4)
    _drive(srv, [m for m in MORE if m[0] == did])
    toks, logits = world["after"][did]
    np.testing.assert_array_equal(srv.tokens(did), toks)
    np.testing.assert_allclose(srv.logits(did), logits, atol=3e-4)
    return srv


def test_reference_snapshot_imports_into_the_port(world):
    srv = _adopt_and_serve(world, "a", world["paths"]["ref_a"])
    assert srv.stats.imports == 1 and srv.tier("a") == "hot"


def test_reference_cold_spill_imports_into_the_port(world):
    """A cold-tier file the reference's store spilled (at its deterministic
    path) is a full serving snapshot the port adopts."""
    _adopt_and_serve(world, "b", world["paths"]["cold_b"])


def test_port_snapshot_reads_in_the_reference(world):
    """Same keys, dtypes and shapes as the reference's own snapshot of the
    same document; the reference restores and adopts the port's file."""
    p_port, p_ref = world["paths"]["port_a"], world["paths"]["ref_a"]
    got, want = np.load(p_port), np.load(p_ref)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
    _, ids, mirrors, meta = ref_restore(p_port)
    _, ids_r, mirrors_r, meta_r = ref_restore(p_ref)
    np.testing.assert_array_equal(ids, ids_r)
    for name in mirrors_r:
        np.testing.assert_array_equal(mirrors[name], mirrors_r[name], err_msg=name)
    assert meta == meta_r
    np.testing.assert_allclose(world["ref_adopted"], world["before"]["a"], atol=3e-4)


def test_document_state_roundtrip_is_bit_exact(world, tmp_path):
    doc = world["port"].docs["b"]
    path = str(tmp_path / "doc.npz")
    port_store.save_document_state(path, doc.state, allocator_ids=doc.allocator.snapshot(),
                                   invalid_from=17, touched_from=None, extra={"doc_id": "b"})
    state, ids, meta = port_store.restore_document_state(path)
    for name, a, b in zip(state._fields, state_to_host(doc.state), state):
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert a.dtype == b.dtype, name
    np.testing.assert_array_equal(ids, doc.allocator.snapshot())
    assert meta == {"doc_id": "b", "invalid_from": 17, "touched_from": None}
    with pytest.raises(TypeError):
        port_store.save_document_state(str(tmp_path / "x.npz"), {"not": "a state"},
                                       allocator_ids=np.arange(3))
    bare = str(tmp_path / "y.npz")
    np.savez(bare, **{"state/tokens": np.zeros(4, np.int32)})
    with pytest.raises(KeyError):
        port_store.restore_document_state(bare)
    with pytest.raises(KeyError, match="mirror"):
        port_store.restore_serving_document(path)  # a bare document checkpoint


def test_interrupted_atomic_savez_leaves_no_visible_file(tmp_path, monkeypatch):
    """A write that dies mid-archive: a new path never appears, an existing
    one keeps its previous complete archive, and no temp file survives."""
    old = str(tmp_path / "old.npz")
    port_store.atomic_savez(old, {"a": np.arange(4)})
    new = str(tmp_path / "new.npz")

    def dying_savez(fp, **arrays):
        fp.write(b"PK\x03\x04 truncated")
        raise RuntimeError("simulated crash mid-write")

    monkeypatch.setattr(np, "savez", dying_savez)
    for path in (old, new):
        with pytest.raises(RuntimeError, match="simulated crash"):
            port_store.atomic_savez(path, {"a": np.arange(9)})
    monkeypatch.undo()
    assert not os.path.exists(new)
    np.testing.assert_array_equal(np.load(old)["a"], np.arange(4))
    assert sorted(os.listdir(tmp_path)) == ["old.npz"]
