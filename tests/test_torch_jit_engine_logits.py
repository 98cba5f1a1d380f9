"""``JitIncrementalEngine.logits_last`` of the port against the
reference's (``repro/serving/jit_engine.py:692``) on the smoke config's
weights: after ``full_forward`` and after one ``apply_edits`` the logits
at slot -1 are within the reference's 3e-4, and equal the port's
``logits_at`` of the last slot bitwise."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_parity import smoke_params  # noqa: E402
from repro.serving.jit_engine import JitIncrementalEngine as RefEngine  # noqa: E402
from repro_torch.configs.vq_opt_125m import smoke_config as port_smoke  # noqa: E402
from repro_torch.serving.jit_engine import (  # noqa: E402
    OP_REPLACE, JitIncrementalEngine, weights_from_params,
)

C, R, N = 4, 32, 32  # R = N: no edit can overflow the row bucket


@pytest.mark.parametrize("padded", [False, True])
def test_logits_last_matches_reference_after_an_edit(padded):
    cfg, params, np_params = smoke_params()
    rng = np.random.default_rng(11 + padded)
    tokens = rng.integers(0, cfg.vocab, N).astype(np.int32)
    positions = (np.arange(1, N + 1) * 16).astype(np.int32)
    valid = None
    if padded:  # the last 4 slots free: slot -1 is a free slot's row
        valid = np.arange(N) < N - 4
        positions[~valid] = cfg.pos_pool - 1
    slot = np.array([3, 9, 14, -1], np.int32)
    tok = rng.integers(0, cfg.vocab, C).astype(np.int32)
    op = np.where(slot >= 0, OP_REPLACE, 0).astype(np.int32)
    edit = (slot, tok, np.zeros(C, np.int32), op)
    ref = RefEngine(params, cfg, edit_capacity=C, row_capacity=R)
    ours = JitIncrementalEngine({}, port_smoke(), edit_capacity=C, row_capacity=R,
                                device="cpu",
                                _weights=weights_from_params(np_params, port_smoke(),
                                                             device="cpu"))
    rs, ps = ref.full_forward(tokens, positions, valid), ours.full_forward(tokens, positions, valid)
    for step in range(2):
        got = ours.logits_last(ps)
        assert got.shape == (cfg.vocab,)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref.logits_last(rs)), atol=3e-4)
        assert torch.equal(got, ours.logits_at(ps, N - 1))
        if step == 0:
            (rs, r_over), (ps, p_over) = ref.apply_edits(rs, *edit), ours.apply_edits(ps, *edit)
            assert not bool(r_over) and not bool(p_over)
