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
