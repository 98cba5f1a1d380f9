"""The port's ``BatchServer`` at a lossy ``delta_threshold`` (the
sigma-delta tier, DESIGN.md §10) against the reference's, on
``tests/test_torch_batch_server.py``'s seeded stream (a grow, a defrag and
an overflow fallback) with suggestions subscribed on both documents: after
every flush the suggestions are equal; at the end tokens, codes and the
slow-path counters are equal and logits lie within 3e-4. Suggestions also
equal a threshold-0 server's. At threshold 3 both streams suppress rows
(the states drift from the threshold-0 server's); at threshold 1 only
seed 13's does."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_parity import smoke_params  # noqa: E402
from repro.serving.batch_server import BatchServer as RefServer  # noqa: E402
from repro_torch.configs.vq_opt_125m import smoke_config as port_smoke  # noqa: E402
from repro_torch.core.edits import apply_edits  # noqa: E402
from repro_torch.serving.batch_server import BatchServer  # noqa: E402
from test_torch_batch_server import DOCS, SERVER, _stream  # noqa: E402

N_NEW = 4
COUNTERS = ("grows", "defrags", "overflows", "device_grows", "device_defrags",
            "full_forwards", "batch_steps", "edits_applied", "suggest_refreshes",
            "suggest_invalidations", "suggest_cached_hits")


@pytest.fixture(scope="module")
def setup():
    return smoke_params()


def _open(srv):
    srv.open_documents({k: list(v) for k, v in DOCS.items()})
    for did in DOCS:
        srv.submit_suggest(did, N_NEW)
    return srv


@pytest.mark.parametrize("threshold", [1.0, 3.0])
@pytest.mark.parametrize("seed", [11, 13])
def test_server_at_threshold_matches_reference(setup, seed, threshold):
    cfg, params, np_params = setup
    stream = _stream(cfg.vocab, seed=seed)
    ref = _open(RefServer(params, cfg, delta_threshold=threshold, **SERVER))
    ours = _open(BatchServer(np_params, port_smoke(), device="cpu",
                             delta_threshold=threshold, **SERVER))
    exact = _open(BatchServer(np_params, port_smoke(), device="cpu", **SERVER))
    for r, batch in enumerate(stream):
        for srv in (ref, ours, exact):
            for did, e in batch:
                srv.submit_edit(did, e)
            srv.flush()
        for did in DOCS:
            got = ours.suggestion(did)
            assert got is not None and len(got) == N_NEW, (did, r)
            np.testing.assert_array_equal(got, ref.suggestion(did), err_msg=f"{did} round {r}")
            # suggestions stay token-exact at a lossy threshold
            np.testing.assert_array_equal(got, exact.suggestion(did), err_msg=f"{did} round {r}")
    for name in COUNTERS:
        assert getattr(ours.stats, name) == getattr(ref.stats, name), name
    assert ours.stats.grows >= 1 and ours.stats.defrags >= 1
    assert ours.stats.overflows >= 1
    drift = 0.0  # of the states' activations from the threshold-0 server's
    for did, toks in DOCS.items():
        replay = apply_edits(toks, [e for batch in stream for d, e in batch if d == did])
        np.testing.assert_array_equal(ours.tokens(did), replay)
        np.testing.assert_array_equal(ours.tokens(did), ref.tokens(did))
        np.testing.assert_array_equal(ours.state(did).codes.numpy(),
                                      np.asarray(ref.state(did).codes))
        np.testing.assert_allclose(ours.logits(did), np.asarray(ref.logits(did)),
                                   atol=3e-4)
        drift = max(drift, float((ours.state(did).x - exact.state(did).x).abs().max()))
    assert (drift > 0.0) == (threshold == 3.0 or seed == 13)
