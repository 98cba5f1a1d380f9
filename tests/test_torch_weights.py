"""The port's weight bridge and init: ``weights_from_params`` is bitwise
equal to the reference's extraction on the reference's own weights, and the
port's ``init_params`` reproduces the reference's layout, shapes and
dtypes."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import params_to_numpy, smoke_params  # noqa: E402
from repro.configs.vq_opt_125m import smoke_config  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.serving.jit_engine import _weights_from_params  # noqa: E402
from repro_torch.configs.vq_opt_125m import smoke_config as port_smoke  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.serving.jit_engine import weights_from_params  # noqa: E402


def test_weights_from_params_bitwise_equal_reference():
    cfg, params, np_params = smoke_params()
    W, extras, meta = _weights_from_params(params, cfg)
    PW, pextras, pmeta = weights_from_params(np_params, port_smoke(), device="cpu")
    assert pmeta == meta
    assert set(PW) == set(W) and set(pextras) == set(extras)
    for k in W:
        assert PW[k].dtype == torch.float32, k
        np.testing.assert_array_equal(PW[k].numpy(), np.asarray(W[k]), err_msg=k)
    for k in extras:
        np.testing.assert_array_equal(pextras[k].numpy(), np.asarray(extras[k]),
                                      err_msg=k)


def test_init_params_layout_matches_reference():
    cfg = smoke_config(vqt=True)
    ref = params_to_numpy(jax.device_get(T.init_params(jax.random.PRNGKey(0), cfg)))
    ours = init_params(port_smoke(), generator=torch.Generator().manual_seed(0),
                       device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [shapes(v) for v in tree]
        return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))

    assert shapes(ours) == shapes(ref)
    # the scale rules: zero biases, unit norm scales, N(0, 0.5²) codebooks
    layer = ours["stages"][0][0]
    assert not layer["mixer"]["bq"].any() and (layer["norm1"]["scale"] == 1).all()
    assert abs(float(layer["mixer"]["vq"]["codebook"].std()) - 0.5) < 0.05
    assert abs(float(ours["embed"]["pos"].std()) - 0.02) < 0.002
    # and the port's own weights feed the port's engine extraction
    W, _, meta = weights_from_params(ours, port_smoke(), device="cpu")
    assert W["c_wo"].shape == (2, meta["hq"], meta["Q"], meta["d"])


def test_default_device_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(port_smoke(), generator=torch.Generator().manual_seed(0))
