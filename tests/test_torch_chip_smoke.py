"""``chip_smoke.py``'s arithmetic that needs no card: the work and bounds it
states for ``gated_attention`` on each route and for ``delta_gate``, and the
budgets of its tiered phase."""
import dataclasses
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
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


def test_gated_attention_bounds_at_the_families_shapes():
    """phi4-mini's forward (BH=24, n=4096, dh=128): 103.1 GFLOP, 0.6249 ms
    as three TF32 products on the tensor cores; gemma3's global layer
    (BH=16, n=3072, dh=256): 77.3 GFLOP, 0.4687 ms. Both 201.3 MB."""
    for (BH, n, dh), flops, tc_ms in (((24, 4096, 128), 103_104_380_928, 0.624875),
                                      ((16, 3072, 256), 77_334_577_152, 0.468694)):
        nbytes, got = cs.attention_work(BH, n, n, dh)
        assert nbytes == 201_326_592 and got == flops
        ms, by = cs.bound(nbytes, cs.GA_PRODUCTS * got, cs.GA_PEAK)
        assert by == "operations" and abs(ms - tc_ms) < 1e-6


def test_code_flips_exempt_only_near_ties():
    """A code that differs between two routes at the first such layer must
    be a near tie there; later layers inherit the flip."""
    idx = torch.zeros((1, 4, 2), dtype=torch.int32)
    wide, near = torch.ones((1, 4, 2)), torch.full((1, 4, 2), 1e-5)
    fwd = [(idx, wide), (idx, wide)]
    flipped = idx.clone()
    flipped[0, 2, 1] = 3
    # the route's calls come a chunk at a time: rows 0-1, then rows 2-3
    route = lambda first, gap: [(idx[:, :2], wide[:, :2]), (idx[:, :2], wide[:, :2]),
                                (first[:, 2:], gap[:, 2:]), (flipped[:, 2:], wide[:, 2:])]
    rows = cs.code_flips(fwd, route(flipped, near), 2, "t")
    assert rows.tolist() == [[False, False, True, False]]
    with pytest.raises(AssertionError, match="layer 0 away from near-ties"):
        cs.code_flips(fwd, route(flipped, wide), 2, "t")
    with pytest.raises(AssertionError, match="layer 1 away from near-ties"):
        cs.code_flips(fwd, route(idx, wide), 2, "t")  # the first flip is at layer 1
    assert cs.code_flips([], [], 2, "t") is None


def test_families_phase_gates_pass_on_the_cpu(monkeypatch):
    """Phase 16's gates at smoke size on the CPU: phi4-mini's (the kernel
    route, chunked prefill and decode against the forward, the softmax
    model streaming) and gemma3's (a windowed layer streams, the ring
    wraps) with STREAM_THRESHOLD lowered to 64, and the four smoke
    families. The wrappers' CPU calls are counted as launches, and the
    timers (which need the card) are stubbed."""
    from repro_torch.configs import get_config
    from repro_torch.core import vq as vq_mod
    from repro_torch.kernels import gated_attention as gak
    from repro_torch.kernels import vq_assign as vqk
    from repro_torch.models import attention

    def counted(mod, name, fn):
        def call(*a):
            mod.LAUNCHES[name] += 1
            return fn(*a)
        return call

    monkeypatch.setattr(attention, "gated_attention",
                        counted(gak, "gated_attention", attention.gated_attention))
    monkeypatch.setattr(vq_mod, "vq_assign", counted(vqk, "vq_assign", vq_mod.vq_assign))
    monkeypatch.setattr(attention, "STREAM_THRESHOLD", 64)
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "time_ms", lambda fn, warmup=3, iters=25: (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "profiled", lambda fn, names, top: (fn(), dict(
        device_busy_ms=1.0, wall_ms_profiled=1.0, device_idle_share=0.0, kernels={},
        top_kernels=[]))[1])
    phi = cs.phi4_phase(cfg=get_config("phi4-mini-3.8b", smoke=True, vqt=True), n=96,
                        chunk=32, n_dec=4)
    assert phi["launches"] == {"gated_attention": 2, "vq_assign": 2}
    assert phi["softmax"]["attention_routes"]["streaming"] == 2
    assert phi["decode"]["max_logits_diff"] < 2e-3
    gem = cs.gemma3_phase(cfg=get_config("gemma3-12b", smoke=True, vqt=True), n_fwd=96, n_dec=80)
    assert gem["attention_routes"] == {"gated_attention": {"4x96x64": 1}, "streaming": 1}
    assert gem["cache_slots"] == [64, 80]
    smoke = cs.smoke_families()
    assert smoke["h2o-danube-1.8b+vqt"]["launches"] == {"gated_attention": 0, "vq_assign": 2}
    assert smoke["internvl2-1b"]["vision_logits"] == [2, 40, 512]
    assert len(smoke) == 8


def test_recurrent_phase_gates_pass_on_the_cpu(monkeypatch):
    """Phase 17's gates at smoke size on the CPU: rwkv6 (no kernel launch,
    the chunked scan against the sequential one on a length the chunk does
    not divide, decode against the forward), hymba with VQT on a variant
    whose second layer is windowed (``gated_attention`` in the global
    layer, the windowed one streamed with STREAM_THRESHOLD lowered to 64,
    ``vq_assign`` in both, decode against the forward, the softmax model
    streaming both), and the two-layer ring decode past a 16-slot window.
    The wrappers' CPU calls are counted as launches, the timers stubbed."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import LayerCfg
    from repro_torch.core import vq as vq_mod
    from repro_torch.kernels import gated_attention as gak
    from repro_torch.kernels import vq_assign as vqk
    from repro_torch.models import attention

    def counted(mod, name, fn):
        def call(*a):
            mod.LAUNCHES[name] += 1
            return fn(*a)
        return call

    monkeypatch.setattr(attention, "gated_attention",
                        counted(gak, "gated_attention", attention.gated_attention))
    monkeypatch.setattr(vq_mod, "vq_assign", counted(vqk, "vq_assign", vq_mod.vq_assign))
    monkeypatch.setattr(attention, "STREAM_THRESHOLD", 64)
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "time_ms", lambda fn, warmup=3, iters=25: (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "profiled", lambda fn, names, top: (fn(), dict(
        device_busy_ms=1.0, wall_ms_profiled=1.0, device_idle_share=0.0, kernels={},
        top_kernels=[]))[1])
    rwkv = cs.rwkv6_phase(cfg=get_config("rwkv6-7b", smoke=True), n=40, n_dec=8)
    assert rwkv["layer0_scan"]["chunks"] == 3
    assert rwkv["layer0_scan"]["chunked_vs_sequential_max_abs_err"] < 1e-4
    assert rwkv["decode"]["max_logits_diff"] < 2e-3
    smoke = get_config("hymba-1.5b", smoke=True, vqt=True)
    windowed = dataclasses.replace(smoke, stages=(
        ((LayerCfg("hymba", "swiglu"),), 1), ((LayerCfg("hymba", "swiglu", window=16),), 1)))
    hym = cs.hymba_phase(cfg=windowed, n=96, n_dec=8)
    assert hym["launches"] == {"gated_attention": 1, "vq_assign": 2}
    assert hym["attention_routes"] == {"gated_attention": {"4x96x64": 1}, "streaming": 1}
    assert hym["softmax"]["attention_routes"] == {"gated_attention": {}, "streaming": 2}
    assert hym["layer0_scan"]["chunked_vs_sequential_max_abs_err"] < 1e-4
    assert hym["decode"]["max_logits_diff"] < 2e-3
    ring = cs.hymba_ring_phase(cfg=windowed, n_dec=40)
    assert ring["cache_slots"] == [40, 16] and ring["windows"] == [None, 16]
    assert ring["forward_launches"] == {"gated_attention": 1, "vq_assign": 2}
    assert ring["decode"]["max_logits_diff"] < 2e-3


def _stub_card(monkeypatch):
    """Count the wrappers' CPU calls as launches, lower STREAM_THRESHOLD to
    64 and stub the timers, as the families' rehearsals do."""
    from repro_torch.core import vq as vq_mod
    from repro_torch.kernels import gated_attention as gak
    from repro_torch.kernels import vq_assign as vqk
    from repro_torch.models import attention

    def counted(mod, name, fn):
        def call(*a):
            mod.LAUNCHES[name] += 1
            return fn(*a)
        return call

    monkeypatch.setattr(attention, "gated_attention",
                        counted(gak, "gated_attention", attention.gated_attention))
    monkeypatch.setattr(vq_mod, "vq_assign", counted(vqk, "vq_assign", vq_mod.vq_assign))
    monkeypatch.setattr(attention, "STREAM_THRESHOLD", 64)
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "time_ms", lambda fn, warmup=3, iters=25: (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "profiled", lambda fn, names, top: (fn(), dict(
        device_busy_ms=1.0, wall_ms_profiled=1.0, device_idle_share=0.0, device_launches=1,
        kernels={}, top_kernels=[]))[1])


def test_moe_phase_gates_pass_on_the_cpu(monkeypatch):
    """Phase 18's gates at smoke size on the CPU: deepseek-v2 with VQT (a
    96-token forward whose MLA streams past the lowered threshold, one
    ``vq_assign`` a layer at dv = 128, no ``gated_attention``; layer 0's
    streaming MLA against the dense scores; the routed MoE against the
    loop form on 32 tokens; ``moe_per_code`` on 8 rows indexed by [2, 16]
    against the dense MoE; 8 decode steps against the forward), then
    deepseek-v3 with its MTP head (both logits finite and [1, n, vocab])."""
    from repro_torch.configs import get_config

    _stub_card(monkeypatch)
    v2 = cs.deepseek_v2_phase(cfg=get_config("deepseek-v2-236b", smoke=True, vqt=True),
                              n=96, n_dec=8, n_moe=32, per_code=(8, 2, 16))
    assert v2["launches"] == {"gated_attention": 0, "vq_assign": 2}
    assert v2["vq_calls"] == {"96x128": 2}
    assert len(v2["experts_run_per_moe_layer"]) == 1
    assert v2["layer0_mla"]["streaming_vs_dense_max_abs_err"] < 2e-5
    assert v2["moe_layer"]["layer"] == 1
    assert v2["moe_layer"]["routed_vs_loop_max_abs_err"] < 2e-5
    assert v2["moe_layer"]["per_code"]["kept_rows"] == 8
    assert v2["decode"]["max_logits_diff"] < 2e-3 and len(
        v2["decode"]["max_logits_diff_by_step"]) == 8
    v3 = cs.deepseek_v3_phase(cfg=get_config("deepseek-v3-671b", smoke=True, vqt=True),
                              n=32, n_dec=6)
    assert v3["mtp"] and v3["vq_calls"] == {"32x128": 2}
    assert v3["decode"]["max_logits_diff"] < 2e-3


def test_moe_loop_form_is_the_reference_loop():
    """``moe_loop_form`` (every expert on every token, gated) equals the
    reference's ``moe_apply_dense`` on the same weights and tokens, and the
    port's routed dispatch equals it within 2e-5."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from _torch_parity import params_to_numpy
    from repro.configs import get_config as ref_get_config
    from repro.models import moe as ref_moe
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.transformer import params_from_numpy

    cfg = get_config("deepseek-v2-236b", smoke=True)
    pj = ref_moe.moe_init(jax.random.PRNGKey(3), ref_get_config("deepseek-v2-236b", smoke=True))
    pt = params_from_numpy(params_to_numpy(pj), device="cpu")
    x = np.random.default_rng(3).standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    loop = cs.moe_loop_form(pt, cfg, torch.tensor(x))
    want, _ = ref_moe.moe_apply_dense(pj, ref_get_config("deepseek-v2-236b", smoke=True),
                                      jnp.asarray(x))
    np.testing.assert_allclose(loop.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    routed, _ = moe.moe_apply_dense(pt, cfg, torch.tensor(x))
    np.testing.assert_allclose(routed.numpy(), loop.numpy(), atol=2e-5, rtol=2e-5)


def test_route_flips_exempt_near_ties_and_raise_otherwise():
    """A token whose experts differ between two routes is returned when its
    k-th and (k+1)-th probabilities lie within ROUTE_TIE in either route,
    and raises otherwise; decode routes (one call a step) and per-code
    routes (token t is row index[t]) line up with the forward's tokens."""
    ids = torch.tensor([[0, 1], [1, 2], [0, 3]])
    gap = torch.tensor([0.1, 5e-6, 0.2])
    fwd = [(ids, gap)]
    steps = [(ids[i:i + 1].clone(), gap[i:i + 1]) for i in range(3)]
    assert cs.route_flips(fwd, steps, 1, "t").tolist() == [False, False, False]
    steps[1] = (torch.tensor([[1, 3]]), gap[1:2])  # at the near tie
    assert cs.route_flips(fwd, steps, 1, "t").tolist() == [False, True, False]
    assert cs.route_ties(fwd) == 1
    steps[2] = (torch.tensor([[0, 2]]), gap[2:3])  # away from a near tie
    with pytest.raises(AssertionError, match="away from a near tie"):
        cs.route_flips(fwd, steps, 1, "t")
    rows = [(torch.tensor([[0, 1], [1, 3]]), torch.tensor([0.1, 5e-6]))]
    index = torch.tensor([0, 1, 0])
    fwd2 = [(ids[[0, 1, 0]], gap[[0, 1, 0]])]
    assert cs.route_flips(fwd2, rows, 1, "t", index=index).tolist() == [False, True, False]


def test_decode_gate_raises_on_a_wrong_step(monkeypatch):
    """``decode_check`` fails when the decode's logits leave the forward's
    by more than 2e-3 in a row without a flip."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    _stub_card(monkeypatch)
    cfg = get_config("deepseek-v2-236b", smoke=True)
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab, (1, 6), generator=torch.Generator().manual_seed(1))
    ok = cs.decode_check(params, cfg, toks, 6, "t", "cpu")
    assert ok["max_logits_diff"] < 2e-3 and ok["route_flip_rows"] == 0
    step = T.decode_step
    monkeypatch.setattr(T, "decode_step", lambda *a: (lambda r: (r[0] + 0.01, r[1]))(step(*a)))
    with pytest.raises(AssertionError, match="logits differ"):
        cs.decode_check(params, cfg, toks, 6, "t", "cpu")


@pytest.mark.parametrize("n", [1, 5, 64, 70])
def test_attention_bwd_work_counts_five_products_a_causal_pair(n):
    """The backward's work at nq = nk = n: q, k, v and dO read once, dq, dk
    and dv written once; the 5 products the gradient needs (S, dW, dV, dK,
    dQ; not the kernels' recomputed S and dW) of 2 dh operations for every
    pair the plain version's mask keeps."""
    from repro_torch.kernels.gated_attention import gated_attention_bwd_ref

    q = k = torch.ones((1, n, 64))
    dv = gated_attention_bwd_ref(q, k, torch.zeros((1, n, 64)), torch.ones((1, n, 64)))[2]
    attended = int(sum(min(i + 1, n) for i in range(n)))
    assert float(dv[0, :, 0].sum()) > 0  # every key is attended by its own row
    nbytes, flops = cs.attention_bwd_work(3, n)
    assert nbytes == 7 * 3 * n * 64 * 4
    assert flops == 3 * attended * 5 * 2 * 64


def test_gated_attention_bwd_bound_at_the_train_shape():
    """BH=96 (8 x 12 heads), n=1024: 32.24 GFLOP, 0.195 ms as 3xTF32 on
    the tensor cores (the route's peak, as the forward's bound), 0.481 ms
    on the FP32 cores; its 176 MB are 0.053 ms at 3.35 TB/s."""
    nbytes, flops = cs.attention_bwd_work(96, 1024)
    assert nbytes == 176_160_768 and flops == 32_243_712_000
    ms, by = cs.bound(nbytes, cs.GA_PRODUCTS * flops, cs.GA_PEAK)
    assert by == "operations" and abs(ms - 0.195416) < 1e-5
    ms, by = cs.bound(nbytes, flops)
    assert by == "operations" and abs(ms - 0.481250) < 1e-5


def test_bwd_sweep_holds_the_train_shape_and_a_ragged_n():
    """``--sweep gated_attention_bwd`` times the VQ-OPT-125M train step's
    shape (BH = 96: 8 x 12 heads, n = 1024), a ragged n (not a whole number
    of 64-row tiles), a long one, each BH = 48 shape of at least a tile
    that the kernels phase checks, and every family shape of phase 20
    (phi4-mini's dh = 128, gemma3's 256, hymba's BH = 25, each at the
    train step's n = 4096)."""
    assert (96, 1024, 64) in cs.SWEEP_BWD
    assert any(n % 64 for _, n, _ in cs.SWEEP_BWD)
    assert max(n for _, n, _ in cs.SWEEP_BWD) >= 2048
    assert {n for BH, n in cs.BWD_ATTENTION if BH == 48 and n >= 64} <= {
        n for BH, n, dh in cs.SWEEP_BWD if BH == 48 and dh == 64}
    assert set(cs.BWD_FAMILIES) <= set(cs.SWEEP_BWD)
    assert {(24, 4096, 128), (16, 4096, 256), (25, 4096, 64)} <= set(cs.BWD_FAMILIES)
    assert {dh for _, n, dh in cs.BWD_FAMILIES if n % 64} == {128, 256}
    assert "gated_attention_bwd" in cs.SWEEPS


@pytest.mark.parametrize("BH,n,dh,flops,tc_ms,fp32_ms", [
    (24, 4096, 128, 2.577e11, 1.562, 3.847),  # phi4-mini: 24 heads of 128
    (16, 4096, 256, 3.437e11, 2.083, 5.129),  # gemma3's global layer: 16 of 256
    (25, 4096, 64, 1.343e11, 0.814, 2.004),   # hymba's global layers: 25 of 64
])
def test_gated_attention_bwd_bounds_at_the_families_shapes(BH, n, dh, flops, tc_ms, fp32_ms):
    """The backward's work at phase 20's shapes: 5 products of 2 dh
    operations a causal pair, n (n + 1) / 2 pairs a head; both bounds are
    operations (the 3xTF32 route's over 495 TFLOP/s, three products each,
    and the FP32 cores' over 67 TFLOP/s)."""
    nbytes, got = cs.attention_bwd_work(BH, n, dh)
    assert got == 5 * 2 * BH * n * (n + 1) // 2 * dh
    assert abs(got / flops - 1) < 1e-3 and nbytes == 7 * BH * n * dh * 4
    ms, by = cs.bound(nbytes, cs.GA_PRODUCTS * got, cs.GA_PEAK)
    assert by == "operations" and abs(ms - tc_ms) < 1e-3
    ms, by = cs.bound(nbytes, got)
    assert by == "operations" and abs(ms - fp32_ms) < 1e-3


def _bwd_check_row(BH, n, err, dh=64):
    nbytes, flops = cs.attention_bwd_work(BH, n, dh)
    bound_ms, by = cs.bound(nbytes, cs.GA_PRODUCTS * flops, cs.GA_PEAK)
    return dict(BH=BH, n=n, dh=dh, max_abs_err=err,
                rel_err={"dq": err, "dk": err / 2, "dv": 0.0},
                ms=1.0, plain_ms=4.0, dkv_ms=0.6, dq_ms=0.4, bound_ms=bound_ms, bound_by=by,
                cores=cs.GA_CORES, bound_fp32_ms=cs.bound(nbytes, flops)[0],
                bound_tc_3xtf32_ms=bound_ms)


def test_bwd_kernel_entry_replaces_no_pallas_entry():
    """The backward's entry of the kernels line: no ``replaces`` (it is the
    gradient of the forward, which the reference takes from plain JAX), the
    contract's keys, the train shape's numbers, the dK/dV and dQ split, and
    the worst error over every checked shape."""
    gabs = [_bwd_check_row(48, 1024, 3e-7), _bwd_check_row(96, 1024, 2e-7),
            _bwd_check_row(48, 37, 5e-7)]
    entry = cs.bwd_kernel_entry(gabs, launches=192)
    assert "replaces" not in entry and "plain JAX" in entry["gradient_of"]
    contract = {"name", "route", "source", "launches", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms"}
    assert contract <= set(entry)
    assert (entry["name"], entry["route"]) == ("gated_attention_bwd", "cuda")
    assert (ROOT / entry["source"]).is_file()
    assert entry["launches"] == 192 and entry["library_ms"] is None
    assert entry["max_abs_err"] == 5e-7 and entry["max_rel_err"] == 5e-7
    assert entry["bound_ms"] == gabs[1]["bound_ms"] and entry["bound_by"] == "operations"
    assert (entry["dkv_ms"], entry["dq_ms"], entry["cores"]) == (0.6, 0.4, cs.GA_CORES)
    assert entry["head_dims"] == []


def test_bwd_kernel_entry_gives_the_families_head_dims():
    """With phase 20's launches by head dim, the entry carries a row for
    each family shape at n = 4096 (not the ragged n = 1000 checks): the
    contract's keys, its launches, its time split and both bounds."""
    gabs = [_bwd_check_row(96, 1024, 2e-7)] + [
        _bwd_check_row(BH, n, 1e-6 * dh / 64, dh=dh) for BH, n, dh in cs.BWD_FAMILIES]
    entry = cs.bwd_kernel_entry(gabs, launches=192, head_dims={64: 6, 128: 24, 256: 2})
    rows = {row["dh"]: row for row in entry["head_dims"]}
    assert sorted(rows) == [64, 128, 256] and all(r["n"] == 4096 for r in rows.values())
    assert (rows[128]["BH"], rows[256]["BH"], rows[64]["BH"]) == (24, 16, 25)
    assert {dh: r["launches"] for dh, r in rows.items()} == {64: 6, 128: 24, 256: 2}
    contract = {"launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "dkv_ms", "dq_ms", "bound_fp32_ms"}
    assert all(contract <= set(r) for r in rows.values())
    assert rows[256]["bound_ms"] == gabs[3]["bound_ms"] and rows[256]["library_ms"] is None
    assert entry["max_abs_err"] == 4e-6 and entry["launches"] == 192


@pytest.mark.parametrize("flips,draws", [((1, 0), 2), ((2, 1, 3), None)])
def test_card_vs_cpu_step_redraws_noise_after_a_tie_flip(monkeypatch, flips, draws):
    """A draw of Gumbel noise in which a code flipped at a near tie is drawn
    again; the gates hold on the first draw with none, and the step raises
    when every one of ``TRAIN_DRAWS`` draws flipped (CPU against CPU, the
    flips stubbed)."""
    from repro_torch.configs.vq_opt_125m import smoke_config

    seen = iter(flips)
    monkeypatch.setattr(cs, "first_layer_flips", lambda *a: next(seen))
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    if draws is None:
        with pytest.raises(AssertionError, match="each of 3 draws"):
            cs.card_vs_cpu_step(smoke_config(), b=1, n=16)
        return
    out = cs.card_vs_cpu_step(smoke_config(), b=1, n=16)
    assert out["noise_draws"] == draws and out["near_tie_flips"] == list(flips)
    assert out["loss_diff"] == 0.0 and out["grad_max_rel_err"] == 0.0


def test_train_phase_gates_pass_on_the_cpu(monkeypatch):
    """Phase 19's gates at smoke size on the CPU: the card-vs-CPU step (here
    CPU against CPU), 6 train steps whose loss falls with 2 forward and one
    of each backward launch a layer a step (the wrappers' CPU calls
    counted), 3 distill steps, and the checkpoint's bitwise round trip and
    served logits."""
    from repro_torch.configs.vq_opt_125m import smoke_config
    from repro_torch.kernels import gated_attention as gak
    from repro_torch.kernels.gated_attention import ops as ga_ops

    def counted(names, fn):
        def call(*a):
            for name in names:
                gak.LAUNCHES[name] += 1
            return fn(*a)
        return call

    monkeypatch.setattr(ga_ops, "_forward_bh", counted(("gated_attention",), ga_ops._forward_bh))
    monkeypatch.setattr(ga_ops, "gated_attention_bwd_bh", counted(
        ("gated_attention_bwd_dkv", "gated_attention_bwd_dq"), ga_ops.gated_attention_bwd_bh))
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    out = cs.train_phase(cfg=smoke_config(), teacher_cfg=smoke_config(vqt=False), steps=6,
                         b=4, n=32, check=(2, 32), device="cpu")
    assert out["card_vs_cpu"]["noise_draws"] == 1 and out["card_vs_cpu"]["loss_diff"] < 1e-5
    train = out["train"]
    assert train["launches_per_step"] == {"gated_attention": 4.0,
                                          "gated_attention_bwd_dkv": 2.0,
                                          "gated_attention_bwd_dq": 2.0}
    assert train["lm_loss"][-1] < train["lm_loss"][0] and len(train["grad_norm"]) == 6
    assert len(out["distill"]) == 3 and out["checkpoint"]["bitwise"]


def test_family_train_phase_gates_pass_on_the_cpu(monkeypatch):
    """Phase 20's gates at smoke size on the CPU: the card-vs-CPU steps
    (here CPU against CPU) of every ``FAMILY_TRAIN_CHECK`` family, phi4-mini
    and gemma3 at their full head dims; then 3 train steps of each
    ``FAMILY_TRAIN`` model's smoke config: finite losses, moved parameters,
    2 forward and one of each backward launch a σ layer a step (the
    wrappers' CPU calls counted; none for rwkv6 and the MLA model), the
    census by shape, and the backward's launches by head dim."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import gated_attention as gak
    from repro_torch.kernels.gated_attention import ops as ga_ops

    def counted(names, fn):
        def call(*a):
            for name in names:
                gak.LAUNCHES[name] += 1
            return fn(*a)
        return call

    monkeypatch.setattr(ga_ops, "_forward_bh", counted(("gated_attention",), ga_ops._forward_bh))
    monkeypatch.setattr(ga_ops, "gated_attention_bwd_bh", counted(
        ("gated_attention_bwd_dkv", "gated_attention_bwd_dq"), ga_ops.gated_attention_bwd_bh))
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    models = [(arch, get_config(arch, smoke=True, vqt=True)) for arch, _ in cs.FAMILY_TRAIN]
    out = cs.family_train_phase(models=models, n=48, device="cpu")
    assert set(out["card_vs_cpu"]) == {
        "deepseek-v2-236b-dh64", "deepseek-v3-671b-dh64", "hymba-1.5b-dh64", "rwkv6-7b-dh64",
        "phi4-mini-3.8b-dh128", "gemma3-12b-dh256"}
    for check in out["card_vs_cpu"].values():
        assert check["noise_draws"] == 1 and check["loss_diff"] == 0.0
    per_step = {name: m["launches_per_step"] for name, m in out["models"].items()}
    bwd = {"gated_attention_bwd_dkv": 2.0, "gated_attention_bwd_dq": 2.0}
    assert per_step == {"hymba-1.5b": {"gated_attention": 4.0, **bwd},
                        "phi4-mini-3.8b": {"gated_attention": 4.0, **bwd},
                        "gemma3-12b": {"gated_attention": 2.0,
                                       "gated_attention_bwd_dkv": 1.0,
                                       "gated_attention_bwd_dq": 1.0},
                        "rwkv6-7b": {}, "deepseek-v2-236b": {}}
    assert out["models"]["gemma3-12b"]["gated_attention_per_step"] == {
        "forward": {"4x48x64": 2.0}, "backward": {"4x48x64": 1.0}}
    assert out["bwd_launches_by_head_dim"] == {64: 30}
    for m in out["models"].values():
        assert len(m["lm_loss"]) == 3 and np.isfinite(m["lm_loss"] + m["grad_norm"]).all()


@pytest.mark.parametrize("arch,depth,layers,sigma", [
    ("hymba-1.5b", None, 32, 3), ("phi4-mini-3.8b", 12, 12, 12), ("gemma3-12b", 6, 6, 1),
    ("rwkv6-7b", 4, 4, 0), ("deepseek-v2-236b", 1, 1, 0)])
def test_family_train_cuts_keep_the_published_widths(arch, depth, layers, sigma):
    """Phase 20's configs: each arch's full-width config with VQT, only the
    depth cut (gemma3 to one 5-local : 1-global pattern, deepseek-v2 to its
    dense MLA layer), and the σ layers that launch ``gated_attention``."""
    from repro_torch.configs import get_config

    cfg = cs.family_train_cfg(arch, depth)
    full = get_config(arch, vqt=True)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.vocab,
            cfg.d_ff, cfg.vqt) == (full.d_model, full.n_heads, full.n_kv_heads,
                                   full.resolved_head_dim, full.vocab, full.d_ff, full.vqt)
    assert cfg.n_layers == len(cfg.layer_list()) == layers
    assert cs.sigma_layers(cfg) == sigma
    assert dict(cs.FAMILY_TRAIN)[arch] == depth
