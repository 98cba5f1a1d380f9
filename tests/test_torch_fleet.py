"""The port's fleet: router, replica workers, shared cold tier — the layers
of ``tests/test_fleet.py`` on ``repro_torch``, with CPU workers.

1. cross-replica migration is invisible: a migrated document's logits are
   bitwise-equal and its suggestions token-exact against a never-migrated
   in-process server, through grows and defrags on both sides of the move;
2. failover: a hard-killed replica's documents resume token-exact on the
   survivor, the client replaying exactly the tickets that failed;
3. the router's aggregated stats reconcile with the replicas' and with the
   acked work;
4. ``close_fleet`` leaves no process, no cold file and no lease;
5. fast unit layers: leases, RPC framing, the crash-safe cold-tier write,
   and a worker entry point that claims its pipe before ``torch`` loads.

The process tests carry the reference's ``slow`` mark."""
import io
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.checkpoint.store import atomic_savez  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.serving.batch_server import BatchServer  # noqa: E402
from repro_torch.serving.fleet import (  # noqa: E402
    FleetRouter, RemoteOpError, ReplicaDiedError, cold_tier,
)
from repro_torch.serving.fleet.protocol import ProtocolError, recv_msg, send_msg  # noqa: E402

WAIT = 600.0
N_NEW = 4
# tiny capacity + position pool: insert streams force grows AND defrags
SERVER_KW = {"edit_capacity": 4, "row_capacity": 16, "max_batch": 4,
             "min_doc_capacity": 8, "pos_pool": 64}
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


# ------------------------------------------------------------- fast layers


def test_lease_protocol(tmp_path):
    cold = str(tmp_path)
    cold_tier.acquire_lease(cold, "doc", "r0")
    assert cold_tier.lease_owner(cold, "doc") == "r0"
    cold_tier.acquire_lease(cold, "doc", "r0")  # idempotent re-acquire
    with pytest.raises(cold_tier.LeaseHeldError):
        cold_tier.acquire_lease(cold, "doc", "r1")
    with pytest.raises(cold_tier.LeaseHeldError):
        cold_tier.release_lease(cold, "doc", "r1")
    cold_tier.release_lease(cold, "doc", "r0")
    assert cold_tier.lease_owner(cold, "doc") is None
    cold_tier.release_lease(cold, "doc", "r0")  # missing lease: no-op
    cold_tier.acquire_lease(cold, "doc", "r1")
    cold_tier.break_lease(cold, "doc")
    assert cold_tier.lease_owner(cold, "doc") is None


def test_cold_path_names(tmp_path):
    a = cold_tier.cold_path_for(str(tmp_path), "weird/../doc id!")
    b = cold_tier.cold_path_for(str(tmp_path), "weird/../doc id?")
    assert a != b
    assert os.path.dirname(a) == str(tmp_path)
    assert "/.." not in os.path.basename(a) and " " not in os.path.basename(a)
    assert a == cold_tier.cold_path_for(str(tmp_path), "weird/../doc id!")


def test_cold_path_names_match_the_reference(tmp_path):
    """Both packages name a document's spill alike, so a fleet of either
    finds the other's files."""
    from repro.serving.state_store import cold_path_for as ref_cold_path

    for doc in ("a", "weird/../doc id!", "x" * 200):
        assert cold_tier.cold_path_for(str(tmp_path), doc) == ref_cold_path(str(tmp_path), doc)


def test_protocol_framing_roundtrip():
    buf = io.BytesIO()
    msgs = [{"id": 1, "ops": [{"op": "ping"}]}, {"arr": np.arange(5), "s": "x"}]
    for m in msgs:
        send_msg(buf, m)
    buf.seek(0)
    got = [recv_msg(buf), recv_msg(buf)]
    assert got[0] == msgs[0]
    np.testing.assert_array_equal(got[1]["arr"], msgs[1]["arr"])
    with pytest.raises(EOFError):
        recv_msg(buf)
    with pytest.raises(EOFError):
        recv_msg(io.BytesIO(b"\x00\x00"))
    with pytest.raises(ProtocolError):
        recv_msg(io.BytesIO(b"\xff\xff\xff\xff"))


def test_interrupted_spill_never_visible(tmp_path, monkeypatch):
    path = str(tmp_path / "doc.state.npz")
    atomic_savez(path, {"a": np.arange(4)})
    real_savez = np.savez

    def dying_savez(fp, **arrays):
        fp.write(b"PK\x03\x04 truncated")
        raise RuntimeError("simulated crash mid-spill")

    monkeypatch.setattr(np, "savez", dying_savez)
    with pytest.raises(RuntimeError, match="simulated crash"):
        atomic_savez(path, {"a": np.arange(9)})
    monkeypatch.setattr(np, "savez", real_savez)
    np.testing.assert_array_equal(np.load(path)["a"], np.arange(4))
    assert [f for f in os.listdir(tmp_path) if ".tmp" in f] == []


def test_worker_claims_its_pipe_before_torch_loads():
    """The worker's entry point (and every package above it) imports no
    torch: ``main`` redirects stdout before anything heavy can print."""
    code = ("import sys, repro_torch.serving.fleet.worker as w; "
            "assert 'torch' not in sys.modules, sorted(m for m in sys.modules if 'torch' in m); "
            "assert callable(w.main)")
    env = {**os.environ, "PYTHONPATH": SRC}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)


@pytest.mark.parametrize("device", ["cuda", ("cuda:0", "cuda:1", "cuda:0"),
                                    ["cpu", "cuda:2", "cuda:1"], ["cuda:0"]])
def test_worker_specs_carry_each_replica_its_device(device):
    """``FleetRouter(device=...)``: one device for every replica, or a list
    with one entry a replica, each in its own worker's spec. The specs are
    built without spawning a worker; a list of another length raises."""
    from repro_torch.serving.fleet.router import worker_specs

    if isinstance(device, str):
        want = [device] * 3
    elif len(device) != 3:
        with pytest.raises(ValueError, match="1 devices for 3 replicas"):
            worker_specs(3, device, arch="vq-opt-125m")
        return
    else:
        want = list(device)
    specs = worker_specs(3, device, arch="vq-opt-125m", smoke=True)
    assert [s["device"] for s in specs] == want
    assert [s["replica"] for s in specs] == ["r0", "r1", "r2"]
    assert all(s["arch"] == "vq-opt-125m" and s["smoke"] for s in specs)


def test_get_config_serves_only_the_ported_model():
    """The ported architectures resolve (VQ-OPT, since the dense families
    gemma3-12b, and since the MLA / MoE families deepseek-v2 with the
    reference's values); a name no package knows raises."""
    from repro.configs import get_config as ref_get_config

    cfg = get_config("vq-opt-125m", smoke=True)
    assert cfg.vqt is not None and get_config("vq-opt-125m").d_model == 768
    gemma = get_config("gemma3-12b")
    assert gemma.resolved_head_dim == 256 and gemma.n_layers == 48
    ds, ref = get_config("deepseek-v2-236b"), ref_get_config("deepseek-v2-236b")
    assert (ds.d_model, ds.n_heads, ds.n_layers, ds.vocab) == (5120, 128, 60, 102400)
    assert (ds.moe.n_experts, ds.moe.top_k, ds.moe.n_shared) == (
        ref.moe.n_experts, ref.moe.top_k, ref.moe.n_shared) == (160, 6, 2)
    with pytest.raises(ValueError, match="unknown architecture"):
        get_config("deepseek-v9")


# -------------------------------------------------------- process fixtures


@pytest.fixture(scope="module")
def oracle():
    cfg = get_config("vq-opt-125m", smoke=True)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")  # == the workers' seed 0
    return cfg, BatchServer(params, cfg, **SERVER_KW, device="cpu")


@pytest.fixture(scope="module")
def fleet2(tmp_path_factory):
    cold = str(tmp_path_factory.mktemp("fleet-cold"))
    fleet = FleetRouter(2, cold_dir=cold, server_kwargs=SERVER_KW,
                        max_batch_delay_ms=3.0, seed=0, device="cpu")
    yield fleet
    fleet.close_fleet()


# ------------------------------------------------------------ slow: migration


@pytest.mark.slow
def test_migration_bitwise_exact(fleet2, oracle):
    """Grow/defrag, migrate, grow/defrag again: logits bitwise-equal and
    suggestions token-exact against the never-migrated server, which takes
    the same edits one dispatch each, as the fleet does."""
    cfg, srv = oracle
    rng = np.random.default_rng(3)
    ref = [int(t) for t in rng.integers(0, cfg.vocab, 7)]
    fleet2.open_document("mig", ref).result(WAIT)
    srv.open_document("mig", ref)
    src = fleet2.owner_of("mig")

    def insert_burst(n):
        for _ in range(n):
            tok = int(rng.integers(cfg.vocab))
            fleet2.submit_insert("mig", 3, tok).result(WAIT)
            srv.submit_insert("mig", 3, tok)
            srv.flush()
            ref.insert(3, tok)

    insert_burst(10)  # past min capacity 8, and through the 64-id pool
    np.testing.assert_array_equal(fleet2.suggest("mig", N_NEW).result(WAIT),
                                  srv.suggest("mig", N_NEW))
    fleet2.migrate("mig", (src + 1) % 2)
    assert fleet2.owner_of("mig") == (src + 1) % 2
    np.testing.assert_array_equal(fleet2.logits("mig").result(WAIT), srv.logits("mig"))
    insert_burst(8)  # the re-ingest paths again, on the adopting replica
    np.testing.assert_array_equal(fleet2.logits("mig").result(WAIT), srv.logits("mig"))
    np.testing.assert_array_equal(fleet2.suggest("mig", N_NEW).result(WAIT),
                                  srv.suggest("mig", N_NEW))
    assert list(fleet2.tokens("mig").result(WAIT)) == ref
    agg = fleet2.stats(WAIT)
    assert agg["exports"] >= 1 and agg["imports"] >= 1
    assert agg["router"]["migrations"] >= 1
    per = agg["per_replica"]
    assert per[src]["batch"]["grows"] >= 1 and per[src]["batch"]["defrags"] >= 1
    assert per[1 - src]["batch"]["defrags"] >= 1


@pytest.mark.slow
def test_stats_reconcile(fleet2, oracle):
    """Fleet aggregation == sum of replica stats == client-side acked work."""
    cfg, _ = oracle
    before = fleet2.stats(WAIT)
    rng = np.random.default_rng(5)
    docs = ["s0", "s1"]
    for d in docs:
        fleet2.open_document(d, [int(t) for t in rng.integers(0, cfg.vocab, 10)]).result(WAIT)
    assert fleet2.owner_of("s0") != fleet2.owner_of("s1")  # load spreads
    n_edits = 6
    tickets = [fleet2.submit_replace(d, i % 10, int(rng.integers(cfg.vocab)))
               for i in range(n_edits // 2) for d in docs]
    for t in tickets:
        t.result(WAIT)
    agg = fleet2.stats(WAIT)
    per = agg["per_replica"]
    for field in ("edits_applied", "hot_hits", "state_touches", "exports", "imports"):
        assert agg[field] == sum(s["batch"][field] for s in per)
    assert agg["rounds"] == sum(s["async"]["rounds"] for s in per)
    assert agg["edits_applied"] - before["edits_applied"] == n_edits
    assert agg["docs_open"] == len(fleet2._route)
    assert agg["router"]["docs_opened"] - agg["router"]["docs_closed"] == agg["docs_open"]
    assert 0.0 <= agg["hot_hit_rate"] <= 1.0
    assert agg["edit_latency"]["count"] == sum(s["batch"]["edit_latency"]["count"] for s in per)
    assert all(b > 0 for b in agg["boot_s"])
    for d in docs:
        fleet2.close_document(d).result(WAIT)


# ------------------------------------------------------------ slow: failover


@pytest.mark.slow
def test_failover_resume_token_exact(tmp_path):
    """Kill a replica with acked, checkpointed AND in-flight edits: its
    documents fail over to the survivor, the client replays exactly the
    failed tickets, and every document's tokens stay exact."""
    cfg = get_config("vq-opt-125m", smoke=True)
    rng = np.random.default_rng(7)
    fleet = FleetRouter(2, cold_dir=str(tmp_path / "cold"), server_kwargs=SERVER_KW,
                        max_batch_delay_ms=3.0, device="cpu")
    try:
        refs = {d: [int(t) for t in rng.integers(0, cfg.vocab, 10)] for d in ("f0", "f1")}
        for d, ref in refs.items():
            fleet.open_document(d, ref).result(WAIT)
        victim = fleet.owner_of("f0")
        survivor = 1 - victim
        assert fleet.owner_of("f1") == survivor
        for i in range(3):
            for d in refs:
                tok = int(rng.integers(cfg.vocab))
                fleet.submit_replace(d, i, tok).result(WAIT)
                refs[d][i] = tok
        fleet.checkpoint(WAIT)
        inflight = []
        for i in range(3):
            tok = int(rng.integers(cfg.vocab))
            inflight.append(((i, tok), fleet.submit_replace("f0", i, tok)))
        fleet.kill_replica(victim)
        assert fleet.stats_fleet.failovers == 1
        assert fleet.owner_of("f0") == survivor
        for (pos, tok), t in inflight:
            try:
                t.result(WAIT)
            except (ReplicaDiedError, RemoteOpError):
                fleet.submit_replace("f0", pos, tok).result(WAIT)
            refs["f0"][pos] = tok
        for d in refs:
            tok = int(rng.integers(cfg.vocab))
            fleet.submit_insert(d, 2, tok).result(WAIT)
            refs[d].insert(2, tok)
            assert list(fleet.tokens(d).result(WAIT)) == refs[d]
        assert len(fleet.suggest("f0", N_NEW).result(WAIT)) == N_NEW
        assert cold_tier.lease_owner(fleet.cold_dir, "f0") == f"r{survivor}"
    finally:
        fleet.close_fleet()
    assert all(r.proc.poll() is not None for r in fleet.replicas)


# ----------------------------------------------------------- slow: leak loop


@pytest.mark.slow
def test_close_fleet_leak_loop(tmp_path):
    """Repeated fleet lifecycles leave nothing behind: no subprocess, no
    cold-tier document files, no leases — even after a checkpoint parked a
    snapshot in the shared directory."""
    cold = str(tmp_path / "cold")
    for it in range(2):
        fleet = FleetRouter(1, cold_dir=cold, server_kwargs=SERVER_KW,
                            max_batch_delay_ms=3.0, device="cpu")
        try:
            fleet.open_document("d", list(range(8))).result(WAIT)
            fleet.submit_insert("d", 0, 5).result(WAIT)
            assert len(fleet.suggest("d", N_NEW).result(WAIT)) == N_NEW
            if it == 1:
                fleet.checkpoint(WAIT)
                assert os.listdir(cold)
        finally:
            fleet.close_fleet()
        assert all(r.proc.poll() is not None for r in fleet.replicas)
        assert os.listdir(cold) == [], f"cold leftovers on iteration {it}"
