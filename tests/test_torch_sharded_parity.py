"""The port's serving mesh against the reference's sharded-parity contracts
(``tests/test_sharded_parity.py``), on the CPU: a mesh of k entries of
``"cpu"`` runs the k-block path in one process, so no forced host devices
and no subprocess are needed.

1. the scheduler's host logic (``_padded_batch``, ``_place_rows``) equals
   the reference's for 1, 2 and 4 blocks;
2. every batched entry point over k = 1, 2, 4 blocks equals the unsharded
   engine (codes exact, x and k within 1e-5, logits within 1e-4), and the
   k = 2 engine equals the reference's ``BatchedJitEngine`` (3e-4);
3. indivisible batches, meshes wider than ``max_batch`` and a ``max_batch``
   that is not a multiple of the mesh are refused; ``make_serving_mesh``
   never returns CPU devices;
4. ``BatchServer`` over k blocks serves a mixed stream with a suggestion
   subscription: tokens and codes equal the op-counting oracle, logits
   within 3e-4, the suggestion equals ``oracle_suggestion``, and the shard
   counters equal a replay of the reference's placement; defrag and grow
   stay exact with one document a block;
5. a one-entry mesh is bitwise the single-device server."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_parity import smoke_params  # noqa: E402
from repro.serving.batch_engine import BatchedJitEngine as RefEngine  # noqa: E402
from repro.serving.batch_server import BatchServer as RefServer  # noqa: E402
from repro.serving.batch_server import BatchStats as RefStats  # noqa: E402
from repro_torch.configs.vq_opt_125m import smoke_config as port_smoke  # noqa: E402
from repro_torch.core.incremental import IncrementalEngine  # noqa: E402
from repro_torch.serving import make_serving_mesh  # noqa: E402
from repro_torch.serving.batch_engine import BatchedJitEngine  # noqa: E402
from repro_torch.serving.batch_server import BatchServer  # noqa: E402
from repro_torch.serving.jit_engine import JitIncrementalEngine, JitState  # noqa: E402
from repro_torch.serving.suggest import oracle_suggestion  # noqa: E402

MESH_SIZES = (1, 2, 4)
SERVER = dict(edit_capacity=4, row_capacity=16, max_batch=4, min_doc_capacity=16,
              pos_pool=2048)


@pytest.fixture(scope="module")
def setup():
    cfg, params, np_params = smoke_params()
    cfg_t = port_smoke()
    base = BatchedJitEngine(np_params, cfg_t, edit_capacity=4, row_capacity=32,
                            device="cpu")
    oracle = IncrementalEngine(np_params, cfg_t, device="cpu")
    return cfg, params, np_params, cfg_t, base, oracle


def _cat(blocks):
    """The k blocks' states (or exports) as one batch."""
    if isinstance(blocks, list):
        return type(blocks[0])(*(torch.cat(leaves) for leaves in zip(*blocks)))
    return blocks


# ------------------------------------------------------- scheduler host logic


def _shell(cls, n_shards: int, max_batch: int = 8):
    """A server with only the fields the host scheduling reads."""
    srv = cls.__new__(cls)
    srv.n_shards = n_shards
    srv.max_batch = max_batch
    return srv


@pytest.mark.parametrize("n_shards", MESH_SIZES)
@pytest.mark.parametrize("what", ["padded_batch", "padded_batch_max6", "place_rows"])
def test_host_scheduling_equals_reference(what, n_shards):
    max_batch = 6 if what == "padded_batch_max6" else 8
    ours = _shell(BatchServer, n_shards, max_batch)
    ref = _shell(RefServer, n_shards, max_batch)
    if what.startswith("padded_batch"):
        for chunk_len in range(1, max_batch + 1):
            got = ours._padded_batch(chunk_len)
            assert got == ref._padded_batch(chunk_len)
            assert got % n_shards == 0 and got >= chunk_len
        return
    rng = np.random.default_rng(n_shards)
    for _ in range(50):
        weights = [int(w) for w in rng.integers(1, 9, int(rng.integers(1, 9)))]
        B_pad = ours._padded_batch(len(weights))
        rows, loads = ours._place_rows(weights, B_pad)
        assert (rows, loads) == ref._place_rows(weights, B_pad)
        assert sorted(i for i in rows if i is not None) == list(range(len(weights)))


# ------------------------------------------------------------- engine parity


def _edit_inputs(cfg, B: int = 4, n: int = 16):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)
    poss = np.tile(np.arange(n, dtype=np.int32) * 5, (B, 1))
    slot = np.asarray([[1, 5, -1, -1]] * B, np.int32)
    tok = np.asarray([[7, 9, 0, 0]] * B, np.int32)
    idx = np.asarray([n - 1] * B, np.int32)
    return toks, poss, slot, tok, idx


@pytest.mark.parametrize("k", MESH_SIZES)
def test_engine_parity_across_mesh_sizes(setup, k):
    """Every batched entry point over k blocks equals the unsharded engine
    per document: codes, tokens and export order exact, floats within
    1e-5 (logits 1e-4)."""
    cfg, _, _, cfg_t, base, _ = setup
    eng = BatchedJitEngine({}, cfg_t, edit_capacity=4, row_capacity=32,
                           mesh=["cpu"] * k, _weights=base.weights)
    assert eng.n_shards == k and eng.device == torch.device("cpu")
    assert len(eng.replicas) == 1  # one replica per distinct device
    toks, poss, slot, tok, idx = _edit_inputs(cfg)
    st, st0 = eng.batch_full_forward(toks, poss), base.batch_full_forward(toks, poss)
    assert isinstance(st, list if k > 1 else JitState)
    torch.testing.assert_close(_cat(st).codes, st0.codes, rtol=0, atol=0)
    torch.testing.assert_close(_cat(st).x, st0.x, rtol=0, atol=1e-5)

    s1, o1 = eng.batch_apply_replaces(st, slot, tok)
    s0, o0 = base.batch_apply_replaces(st0, slot, tok)
    assert torch.equal(o1, o0)
    torch.testing.assert_close(_cat(s1).codes, s0.codes, rtol=0, atol=0)
    torch.testing.assert_close(_cat(s1).x, s0.x, rtol=0, atol=1e-5)

    e1, e0 = _cat(eng.batch_export_kv(s1)), base.batch_export_kv(s0)
    assert torch.equal(e1.order, e0.order) and torch.equal(e1.tokens, e0.tokens)
    torch.testing.assert_close(e1.k, e0.k, rtol=0, atol=1e-5)

    torch.testing.assert_close(eng.batch_logits_at(s1, idx),
                               base.batch_logits_at(s0, idx), rtol=0, atol=1e-4)


def test_two_block_engine_matches_reference(setup):
    """The port's k = 2 engine against the reference's single-device
    ``BatchedJitEngine`` on the same weights and inputs."""
    cfg, params, np_params, cfg_t, base, _ = setup
    ours = BatchedJitEngine({}, cfg_t, edit_capacity=4, row_capacity=32,
                            mesh=["cpu"] * 2, _weights=base.weights)
    ref = RefEngine(params, cfg, edit_capacity=4, row_capacity=32)
    toks, poss, slot, tok, idx = _edit_inputs(cfg)
    s_ref, o_ref = ref.batch_apply_replaces(ref.batch_full_forward(toks, poss), slot, tok)
    s_ours, o_ours = ours.batch_apply_replaces(ours.batch_full_forward(toks, poss), slot, tok)
    cat = _cat(s_ours)
    np.testing.assert_array_equal(o_ours.numpy(), np.asarray(o_ref))
    np.testing.assert_array_equal(cat.codes.numpy(), np.asarray(s_ref.codes))
    np.testing.assert_allclose(cat.x.numpy(), np.asarray(s_ref.x), rtol=0, atol=3e-4)
    np.testing.assert_allclose(ours.batch_logits_at(s_ours, idx).numpy(),
                               np.asarray(ref.batch_logits_at(s_ref, idx)),
                               rtol=0, atol=3e-4)


# ------------------------------------------------------------- rejections


@pytest.mark.parametrize("case", ["indivisible_batch", "max_batch_not_multiple",
                                  "mesh_wider_than_max_batch", "device_not_primary",
                                  "one_stack_for_k_blocks"])
def test_mesh_rejections(setup, case):
    cfg, _, np_params, cfg_t, base, _ = setup
    if case == "indivisible_batch":
        eng = BatchedJitEngine({}, cfg_t, mesh=["cpu"] * 2, _weights=base.weights)
        toks = np.zeros((3, 8), np.int32)
        with pytest.raises(ValueError, match="does not divide"):
            eng.batch_full_forward(toks, np.tile(np.arange(8, dtype=np.int32), (3, 1)))
    elif case == "max_batch_not_multiple":
        with pytest.raises(ValueError, match="not a multiple"):
            BatchServer(np_params, cfg_t, max_batch=3, mesh=["cpu"] * 2)
    elif case == "mesh_wider_than_max_batch":
        with pytest.raises(ValueError, match="exceeds"):
            BatchServer(np_params, cfg_t, max_batch=2, mesh=["cpu"] * 4)
    elif case == "device_not_primary":
        with pytest.raises(ValueError, match="primary device"):
            BatchServer(np_params, cfg_t, device="meta", mesh=["cpu"] * 2)
    else:
        eng = BatchedJitEngine({}, cfg_t, mesh=["cpu"] * 2, _weights=base.weights)
        toks, poss, slot, tok, _ = _edit_inputs(cfg)
        whole = base.batch_full_forward(toks, poss)  # one stack, not k blocks
        with pytest.raises(TypeError, match="per-block states"):
            eng.batch_apply_replaces(whole, slot, tok)


def test_make_serving_mesh_returns_cuda_devices_only():
    """A prefix of the visible CUDA devices; raises past the count and
    below 1 — so without a GPU it always raises."""
    count = torch.cuda.device_count()
    for bad in (0, count + 1):
        with pytest.raises(ValueError, match="visible"):
            make_serving_mesh(bad)
    if count == 0:
        with pytest.raises(ValueError, match="visible"):
            make_serving_mesh()
    else:
        assert make_serving_mesh() == [torch.device("cuda", i) for i in range(count)]


# ---------------------------------------------------------- server end-to-end


def _mixed_stream(srv, cfg, seed: int, n_docs: int, n_ops: int, suggest_doc=None,
                  n_new: int = 4):
    """The reference's ``_mixed_stream``: seeded documents of 10-14 tokens
    and a mixed replace / insert / delete stream, stepped now and then."""
    rng = np.random.default_rng(seed)
    ref = {}
    for i in range(n_docs):
        n = int(rng.integers(10, 15))
        toks = rng.integers(0, cfg.vocab, n)
        ref[f"d{i}"] = list(toks)
        srv.open_document(f"d{i}", toks)
    if suggest_doc is not None:
        srv.submit_suggest(suggest_doc, n_new)
    for _ in range(n_ops):
        did = f"d{int(rng.integers(n_docs))}"
        r = ref[did]
        kind = rng.choice(["replace", "insert", "delete"], p=[0.5, 0.3, 0.2])
        if kind == "insert":
            p, t = int(rng.integers(len(r) + 1)), int(rng.integers(cfg.vocab))
            srv.submit_insert(did, p, t)
            r.insert(p, t)
        elif kind == "delete" and len(r) > 1:
            p = int(rng.integers(len(r)))
            srv.submit_delete(did, p)
            del r[p]
        else:
            p, t = int(rng.integers(len(r))), int(rng.integers(cfg.vocab))
            srv.submit_replace(did, p, t)
            r[p] = t
        if rng.random() < 0.3:
            srv.step()
    srv.flush()
    return ref


def _assert_matches_oracle(srv, ref, oracle, atol=3e-4):
    """Tokens and every layer's codes equal the op-counting engine's full
    forward of the served sequence; logits within ``atol``."""
    for did, r in ref.items():
        assert list(srv.tokens(did)) == r, did
        doc = srv.docs[did]
        ns = oracle.full_forward(doc.seq_tokens(), doc.seq_positions())
        sl = torch.as_tensor(doc.slots)
        for li, layer in enumerate(ns.layers):
            assert torch.equal(doc.state.codes[li][sl], layer.codes), (did, li)
        np.testing.assert_allclose(srv.logits(did), oracle.logits_at(ns).numpy(),
                                   rtol=0, atol=atol)


def _recording_placement(srv) -> list:
    """Record every (weights, B_pad) the server places."""
    calls, place = [], srv._place_rows

    def recorded(weights, B_pad):
        calls.append((list(weights), B_pad))
        return place(weights, B_pad)

    srv._place_rows = recorded
    return calls


@pytest.mark.parametrize("k", MESH_SIZES)
def test_server_differential_vs_oracle(setup, k):
    """Mixed streams and a suggestion subscription over k blocks: tokens
    and codes equal the op-counting oracle, logits within 3e-4, the
    suggestion equals the from-scratch decode oracle, and the shard
    counters equal the reference's accounting of the same placements."""
    cfg, _, np_params, cfg_t, base, oracle = setup
    srv = BatchServer(np_params, cfg_t, mesh=["cpu"] * k, **SERVER)
    calls = _recording_placement(srv)
    ref = _mixed_stream(srv, cfg, seed=6, n_docs=4, n_ops=40, suggest_doc="d0")
    assert srv.pending_count() == 0
    assert srv.stats.edits_applied == srv.stats.edits_submitted
    assert len(calls) == srv.stats.batch_steps + 4  # 4 single-document ingests
    if k > 1:
        assert srv.stats.sharded_dispatches > 0
    _assert_matches_oracle(srv, ref, oracle)
    sugg = srv.suggest("d0", 4)
    doc = srv.docs["d0"]
    oracle_eng = JitIncrementalEngine({}, cfg_t, edit_capacity=4, row_capacity=16,
                                      device="cpu", _weights=srv._weights)
    np.testing.assert_array_equal(sugg, oracle_suggestion(
        srv.suggester.params, cfg_t, oracle_eng, doc.tokens, doc.positions, doc.valid, 4))

    replay = _shell(RefServer, k, SERVER["max_batch"])
    replay.stats = RefStats()
    for weights, B_pad in calls:
        replay._note_balance(replay._place_rows(weights, B_pad)[1])
    for name in ("sharded_dispatches", "shard_imbalance_sum", "mean_shard_imbalance"):
        assert getattr(srv.stats, name) == getattr(replay.stats, name), name
    assert srv.stats.state_moves == 0  # every block is on the one CPU


@pytest.mark.parametrize("k", MESH_SIZES)
def test_server_defrag_and_grow_under_mesh(setup, k):
    """A tiny position pool drives defrags and a tiny slot buffer grows,
    one document a block, so the slow paths fire in every block."""
    cfg, _, np_params, cfg_t, _, oracle = setup
    srv = BatchServer(np_params, cfg_t, edit_capacity=4, row_capacity=16, max_batch=k,
                      min_doc_capacity=8, pos_pool=64, mesh=["cpu"] * k)
    rng = np.random.default_rng(7)
    ref = {}
    for i in range(k):
        toks = rng.integers(0, cfg.vocab, 7)
        ref[f"d{i}"] = list(toks)
        srv.open_document(f"d{i}", toks)
    for _ in range(8):  # one insertion point hammered: defrag; filled: grow
        for i in range(k):
            t = int(rng.integers(cfg.vocab))
            srv.submit_insert(f"d{i}", 3, t)
            ref[f"d{i}"].insert(3, t)
        srv.flush()
    assert srv.stats.defrags >= 1 and srv.stats.grows >= 1
    if k > 1:  # every ingest and every edit dispatch ran k blocks
        assert srv.stats.sharded_dispatches == srv.stats.batch_steps + k
    _assert_matches_oracle(srv, ref, oracle)


def test_mesh_of_one_is_bitwise_single_device(setup):
    """A one-entry mesh reproduces the ``mesh=None`` server bit for bit:
    every state leaf, the host mirrors and the suggestion."""
    cfg, _, np_params, cfg_t, _, _ = setup
    srv_a = BatchServer(np_params, cfg_t, device="cpu", **SERVER)
    srv_b = BatchServer(np_params, cfg_t, mesh=["cpu"], **SERVER)
    ref_a = _mixed_stream(srv_a, cfg, seed=11, n_docs=3, n_ops=24, suggest_doc="d1")
    ref_b = _mixed_stream(srv_b, cfg, seed=11, n_docs=3, n_ops=24, suggest_doc="d1")
    assert ref_a == ref_b
    assert srv_b.n_shards == 1 and srv_b.stats.sharded_dispatches == 0
    for did in ref_a:
        doc_a, doc_b = srv_a.docs[did], srv_b.docs[did]
        np.testing.assert_array_equal(doc_a.tokens, doc_b.tokens)
        np.testing.assert_array_equal(doc_a.positions, doc_b.positions)
        for leaf_a, leaf_b in zip(doc_a.state, doc_b.state):
            assert torch.equal(leaf_a, leaf_b)
        np.testing.assert_array_equal(srv_a.logits(did), srv_b.logits(did))
    np.testing.assert_array_equal(srv_a.suggestion("d1"), srv_b.suggestion("d1"))
