"""``chip_smoke.py``'s arithmetic that needs no card: the work and bounds it
states for ``gated_attention`` on each route and for ``delta_gate``, and the
budgets of its tiered phase."""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

from repro_torch.kernels.gated_attention import gated_attention_ref  # noqa: E402


@pytest.mark.parametrize("nq,nk", [(5, 5), (7, 3), (3, 7), (1, 1), (70, 64)])
def test_attention_work_counts_the_pairs_the_plain_version_attends(nq, nk):
    """One (query, key) pair per nonzero output of the plain version with
    q = k = 1 (every score 8, gelu(8) > 0) and v = I: out[i, j] > 0
    exactly where row i attends key j."""
    q, k, v = torch.ones((1, nq, 64)), torch.ones((1, nk, 64)), torch.eye(nk, 64)[None]
    attended = int((gated_attention_ref(q, k, v) > 0).sum())
    nbytes, flops = cs.attention_work(2, nq, nk)
    assert nbytes == 4 * 2 * 2 * (nq + nk) * 64
    assert flops == 2 * attended * 4 * 64


def test_gated_attention_bounds_at_the_forward_shape():
    """BH=48, n=1024: 6.45 GFLOP and 50.3 MB; 0.0962 ms on the FP32 cores,
    0.0391 ms as three TF32 products each on the tensor cores."""
    nbytes, flops = cs.attention_work(48, 1024, 1024)
    assert nbytes == 50_331_648 and flops == 6_448_742_400
    fp32, by = cs.bound(nbytes, flops)
    assert by == "operations" and abs(fp32 - 0.096249) < 1e-5
    tc, by = cs.bound(nbytes, cs.GA_PRODUCTS * flops, cs.GA_PEAK)
    assert by == "operations" and abs(tc - 0.039083) < 1e-5
    assert cs.bound(nbytes, 0)[1] == "bytes"


@pytest.mark.parametrize("r,nbytes,bound_us", [(256, 1_573_120, 0.469588),
                                               (2048, 12_584_960, 3.756704)])
def test_delta_gate_bound_is_bytes_at_the_served_rows(r, nbytes, bound_us):
    """d=768: both inputs read once and a keep byte a row written, over
    3.35 TB/s; three operations an element are far below the FP32 peak."""
    got_bytes, ops = cs.gate_work(r, 768)
    assert got_bytes == nbytes and ops == 3 * r * 768
    ms, by = cs.bound(got_bytes, ops)
    assert by == "bytes" and abs(ms * 1e3 - bound_us) < 1e-5


def test_tiered_budgets_hold_two_full_states_on_the_card_and_one_on_the_host():
    """At the full VQ-OPT-125M config a 1024-capacity state is 229,745,668
    bytes; the device budget holds two of them and not three (the rest is
    room for one suggestion decode cache), the host budget one and not two."""
    from repro_torch.configs.vq_opt_125m import config
    from repro_torch.serving.jit_engine import state_nbytes_for_config

    cfg = config()
    per = state_nbytes_for_config(cfg, 1024)
    assert per == 229_745_668
    device, host = cs.tiered_budgets(cfg)
    assert 2 * per <= device < 3 * per
    assert per <= host < 2 * per
    assert abs(device - 0.574e9) < 1e6  # ~0.46 GB of two states + half a third


def test_incremental_phase_gates_pass_on_the_cpu():
    """Phase 14 on the smoke config with ``device="cpu"``: short documents
    named like ``DOC_LENGTHS``, the serve stream's form (its inserts run the
    1000-token document's gap out: a defrag) and a CPU ``BatchServer``
    served with it as the second oracle's subject. Every gate passes and
    every emitted field is there."""
    import numpy as np

    from repro_torch.configs.vq_opt_125m import smoke_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.batch_server import BatchServer

    cfg = smoke_config()
    params = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    lens = dict(zip(cs.DOC_LENGTHS, (16, 20, 30, 40)))
    rng = np.random.default_rng(0)
    docs = {did: [int(t) for t in rng.integers(0, cfg.vocab, n)] for did, n in lens.items()}
    stream = cs.make_stream(cfg.vocab, rounds=3, per_doc=3, lens=lens)
    srv = BatchServer(params, cfg, device="cpu")
    srv.open_documents({k: list(v) for k, v in docs.items()})
    for batch in stream:
        for did, e in batch:
            srv.submit_edit(did, e)
        srv.flush()
    out = cs.incremental_phase(params, cfg, docs, stream, srv, device="cpu")
    n_edits = sum(len(b) for b in stream)
    assert out["edits"] == n_edits == len(out["per_edit"])
    assert out["defrags"] >= 1
    assert out["incremental_ops"] == out["ops_open"] + out["ops_edits"]
    assert out["speedup"] == out["full_ops_equiv"] / out["incremental_ops"]
    assert 0 < out["ratio_min"] <= out["ratio_median"] <= out["ratio_max"]
    assert out["ms_per_edit_median"] <= out["ms_per_edit_max"]
    assert set(out["exactness"]) == set(out["batch_server_oracle"]) == set(docs)
    for row in out["exactness"].values():
        assert set(row) == {"n", "flips", "max_abs_x_diff", "logits_diff"}
        assert row["flips"] or (row["logits_diff"] <= 3e-4
                                and row["max_abs_x_diff"] <= 5e-5)
    twin = out["cpu_twin"]
    assert twin["doc"] == "d256" and twin["edits"] == sum(
        d == "d256" for b in stream for d, _ in b)
    assert twin["near_tie_divergences"] == []  # the twin is the same CPU here


def test_mesh_phase_gates_pass_on_the_cpu(monkeypatch):
    """Phase 15 on the smoke config with a two-block mesh of ``"cpu"``:
    the serve stream's form on short documents named like ``DOC_LENGTHS``.
    The engine's ``fused_step`` calls are counted as the card's wrapper
    counts its launches (the CPU runs the plain version, which counts
    none). Every gate passes and the counts add up."""
    import numpy as np

    from repro_torch.configs.vq_opt_125m import smoke_config
    from repro_torch.kernels import fused_step
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import jit_engine

    call = jit_engine.fused_patch_assign_batched

    def counted(*args, **kw):
        fused_step.LAUNCHES["fused_step"] += 1
        return call(*args, **kw)

    monkeypatch.setattr(jit_engine, "fused_patch_assign_batched", counted)
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    cfg = smoke_config()
    params = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    lens = dict(zip(cs.DOC_LENGTHS, (16, 20, 30, 40)))
    rng = np.random.default_rng(0)
    docs = {did: [int(t) for t in rng.integers(0, cfg.vocab, n)] for did, n in lens.items()}
    stream = cs.make_stream(cfg.vocab, rounds=3, per_doc=3, lens=lens)
    out = cs.mesh_phase(params, cfg, docs, stream, mesh=["cpu", "cpu"], device="cpu", n_new=4)
    assert out["k"] == 2 and out["mesh_of_one_bitwise"]
    assert out["launches"]["fused_step"] == 2 * cs.n_layers(cfg) * out["edit_dispatches"]
    assert sum(out["fused_step_block_shapes"].values()) == out["launches"]["fused_step"]
    assert all(key.split("x")[0] in ("1", "2", "4") for key in out["fused_step_block_shapes"])
    assert out["sharded_dispatches"] >= out["edit_dispatches"] > 0
    assert 0.0 <= out["mean_shard_imbalance"] <= 1.0
    assert out["state_moves"] == 0 and list(out["weight_replica_bytes"]) == ["cpu"]
    assert set(out["near_tie_flips"]) == set(docs) and len(out["suggestion"]) == 4
    assert all(d <= 3e-4 for d in out["max_logits_diff"].values())
