"""The pytree half of the port's checkpoints (``checkpoint.save_pytree`` /
``restore_pytree`` / ``save_train_state``, ``common.pytree``) against the
JAX package's: the same key strings, bitwise round trips keeping the
``like`` tree's dtypes and devices, ``KeyError`` / ``ValueError`` as the
reference's, files read both ways, and ``launch.serve --ckpt`` serving the
reference's weights."""
import argparse
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import smoke_params  # noqa: E402
from repro.checkpoint import restore_pytree as ref_restore  # noqa: E402
from repro.checkpoint import save_pytree as ref_save  # noqa: E402
from repro.common.pytree import path_names as ref_path_names  # noqa: E402
from repro.configs.vq_opt_125m import smoke_config as ref_smoke  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.training import step as ref_step  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    restore_pytree, restore_train_state, save_pytree, save_train_state,
)
from repro_torch.common.pytree import (  # noqa: E402
    DictKey, GetAttrKey, SequenceKey, path_entry_name, path_names, tree_flatten_with_path,
)
from repro_torch.configs.vq_opt_125m import smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.training import train_state_init  # noqa: E402


def _port_state(seed=0):
    return train_state_init(smoke_config(), generator=torch.Generator().manual_seed(seed),
                            device="cpu")


def test_path_entries_name_like_the_references():
    assert [path_entry_name(e) for e in (DictKey("w"), SequenceKey(3), GetAttrKey("mu"))] == \
        ["w", "3", "mu"]
    assert path_names((DictKey("a"), SequenceKey(0))) == ("a", "0")


def test_train_state_keys_equal_the_references():
    """A port train state and the reference's flatten to the same key
    strings (``params/stages/0/0/mixer/vq/codebook``, ``opt/mu/...``,
    ``rng``), with the same shapes."""
    ref = ref_step.train_state_init(jax.random.PRNGKey(0), ref_smoke())
    want = {"/".join(ref_path_names(p)): tuple(np.shape(x))
            for p, x in jax.tree_util.tree_flatten_with_path(ref)[0]}
    got = {"/".join(path_names(p)): tuple(x.shape)
           for p, x in tree_flatten_with_path(_port_state())}
    assert got == want
    assert "params/stages/1/0/mixer/vq/codebook" in got and "opt/step" in got


def test_roundtrip_train_state(tmp_path):
    state = _port_state()
    p = str(tmp_path / "ckpt.npz")
    save_train_state(p, state, step=0)
    assert json.load(open(p + ".meta.json")) == {"step": 0}
    like = _port_state(seed=1)
    restored = restore_train_state(p, like)
    assert type(restored) is type(state) and type(restored.params["stages"][0]) is tuple
    for (_, a), (_, b), (_, c) in zip(tree_flatten_with_path(state),
                                      tree_flatten_with_path(restored),
                                      tree_flatten_with_path(like)):
        assert torch.equal(a, b) and b.dtype == c.dtype and b.device == c.device


def test_restore_keeps_the_like_trees_types():
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        p = d + "/t.npz"
        save_pytree(p, {"a": torch.arange(3, dtype=torch.int32), "b": np.ones(2)})
        got = restore_pytree(p, {"a": torch.zeros(3, dtype=torch.float64),
                                 "b": np.zeros(2, np.float32)})
    assert got["a"].dtype == torch.float64 and got["a"].tolist() == [0.0, 1.0, 2.0]
    assert isinstance(got["b"], np.ndarray) and got["b"].dtype == np.float32


def test_restore_shape_mismatch_raises(tmp_path):
    p = str(tmp_path / "x.npz")
    save_pytree(p, {"w": torch.zeros((2, 3))})
    with pytest.raises(ValueError):
        restore_pytree(p, {"w": torch.zeros((3, 2))})


def test_restore_missing_key_raises(tmp_path):
    p = str(tmp_path / "y.npz")
    save_pytree(p, {"w": torch.zeros((2,))})
    with pytest.raises(KeyError):
        restore_pytree(p, {"w": torch.zeros((2,)), "b": torch.zeros((1,))})


def test_a_reference_train_state_restores_in_the_port(tmp_path):
    ref = ref_step.train_state_init(jax.random.PRNGKey(3), ref_smoke())
    p = str(tmp_path / "ref.npz")
    ref_save(p, jax.device_get(ref), metadata={"step": 0})
    got = restore_train_state(p, _port_state())
    np.testing.assert_array_equal(got.params["stages"][1][0]["mixer"]["vq"]["codebook"].numpy(),
                                  np.asarray(ref.params["stages"][1][0]["mixer"]["vq"].codebook))
    np.testing.assert_array_equal(got.rng.numpy(), np.asarray(ref.rng).astype(np.int64))
    assert got.rng.dtype == torch.int64 and int(got.opt.step) == 0


def test_a_port_train_state_restores_in_the_reference(tmp_path):
    state = _port_state(seed=4)
    p = str(tmp_path / "port.npz")
    save_train_state(p, state)
    like = ref_step.train_state_init(jax.random.PRNGKey(0), ref_smoke())
    got = ref_restore(p, like)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                 jax.tree_util.tree_flatten_with_path(like)[0]):
        key = "/".join(ref_path_names(path))
        assert a.dtype == b.dtype, key
    np.testing.assert_array_equal(np.asarray(got.params["embed"]["pos"]),
                                  state.params["embed"]["pos"].numpy())
    assert np.asarray(got.rng).tolist() == state.rng.tolist()


def test_serve_ckpt_serves_the_references_weights(tmp_path, capsys):
    """``launch.serve --ckpt`` on a parameter file the reference wrote: the
    single-document mode prints the reference's lines on those weights, and
    the restored parameters' logits are the reference's within 1e-5."""
    cfg_j, params, _ = smoke_params()
    p = str(tmp_path / "params.npz")
    ref_save(p, params)
    ref_serve.run_single(argparse.Namespace(doc_len=32, edits=5, device="cpu"), cfg_j, params)
    want = capsys.readouterr().out
    serve.main(["--smoke", "--device", "cpu", "--ckpt", p, "--doc-len", "32", "--edits", "5"])
    assert capsys.readouterr().out.splitlines() == want.splitlines()
    like = PT.init_params(smoke_config(), generator=torch.Generator().manual_seed(0),
                          device="cpu")
    tp = restore_pytree(p, like)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg_j.vocab, (1, 24))
    pos = np.sort(rng.choice(cfg_j.pos_pool, (1, 24), replace=False)).astype(np.int32)
    with torch.no_grad():
        got, _ = PT.forward(tp, smoke_config(), torch.tensor(toks), torch.tensor(pos))
    ref, _ = RT.forward(params, cfg_j, jnp.asarray(toks), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
