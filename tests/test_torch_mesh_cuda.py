"""The serving mesh across cards. This file imports neither jax nor the
reference package, so it runs on a machine without JAX (the repo's conftest
imports jax, so run it there without it):

    PYTHONPATH=src python -m pytest --noconftest -m cuda -s tests/test_torch_mesh_cuda.py

Below two NVIDIA GPUs every test skips. With ``-s`` the full-width test
prints ``chip_smoke.py``'s mesh phase line."""
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs.vq_opt_125m import smoke_config  # noqa: E402
from repro_torch.core.edits import Edit, apply_edit  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.serving import make_serving_mesh  # noqa: E402
from repro_torch.serving.batch_server import BatchServer  # noqa: E402

pytestmark = pytest.mark.cuda

SERVER = dict(edit_capacity=4, row_capacity=16, max_batch=2, min_doc_capacity=16,
              pos_pool=2048)


@pytest.fixture
def two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    torch.backends.cuda.matmul.allow_tf32 = False
    return make_serving_mesh(2)


def test_states_moved_between_cards_serve_the_same_tokens(two_cards):
    """Two documents whose buckets take turns being the heavier one: greedy
    LPT puts the heavier on the first card, so each round moves both states
    across. Tokens equal a host replay and a one-card server's, codes equal
    it, logits within 3e-4; a suggestion subscribed on a document resting
    on the second card equals the one-card server's."""
    cfg = smoke_config()
    params = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    mesh = BatchServer(params, cfg, mesh=two_cards, **SERVER)
    one = BatchServer(params, cfg, device="cuda:0", **SERVER)
    rng = np.random.default_rng(0)
    refs = {d: [int(t) for t in rng.integers(0, cfg.vocab, 12)] for d in ("a", "b")}
    for srv in (mesh, one):
        srv.open_documents({d: list(t) for d, t in refs.items()})
        srv.submit_suggest("b", 4)
    for r in range(6):
        heavy, light = ("a", "b") if r % 2 else ("b", "a")
        edits = [(heavy, Edit("replace", int(p), int(rng.integers(cfg.vocab))))
                 for p in rng.choice(12, 3, replace=False)]
        edits.append((light, Edit("replace", int(rng.integers(12)),
                                  int(rng.integers(cfg.vocab)))))
        for d, e in edits:
            refs[d] = apply_edit(refs[d], e)
            for srv in (mesh, one):
                srv.submit_edit(d, e)
        for srv in (mesh, one):
            srv.flush()
        assert mesh.docs[heavy].state.x.device == two_cards[0]
        assert mesh.docs[light].state.x.device == two_cards[1]
        np.testing.assert_array_equal(mesh.suggestion("b"), one.suggestion("b"))
    assert mesh.stats.state_moves >= 10 and mesh.stats.sharded_dispatches >= 6
    assert len(mesh.engine(mesh.C, mesh.R).replicas) == 2
    for d, toks in refs.items():
        assert list(mesh.tokens(d)) == toks == list(one.tokens(d))
        assert torch.equal(mesh.state(d).codes.cpu(), one.state(d).codes.cpu())
        np.testing.assert_allclose(mesh.logits(d), one.logits(d), rtol=0, atol=3e-4)


def test_mesh_phase_across_cards(two_cards):
    """``chip_smoke.py``'s phase 15 at full VQ-OPT-125M width with a block
    a card (2 cards, or 4 where there are 4): its documents, stream and
    gates, against a single-card server, and a one-entry mesh bitwise.
    Every card holds one weight replica."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from repro_torch.configs.vq_opt_125m import config

    cfg = config()
    params = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    docs = {did: [int(t) for t in rng.integers(0, cfg.vocab, n)]
            for did, n in cs.DOC_LENGTHS.items()}
    out = cs.mesh_phase(params, cfg, docs, cs.make_stream(cfg.vocab))
    print(json.dumps({"phase": "mesh", "nvidia_smi": cs.nvidia_smi(), **out}), flush=True)
    assert out["k"] == len(cs.default_mesh()) >= 2
    assert len(out["weight_replica_bytes"]) == out["k"]
