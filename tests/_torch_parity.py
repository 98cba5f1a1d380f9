"""Shared fixtures for the PyTorch-port parity tests (tests/test_torch_*.py):
the reference's smoke-config weights as a nested dict of numpy arrays, the
form both packages accept."""
import jax
import numpy as np

from repro.configs.vq_opt_125m import smoke_config
from repro.models import transformer as T


def params_to_numpy(tree):
    """Reference params -> nested numpy dict (``VQParams`` -> {"codebook"})."""
    if hasattr(tree, "codebook") and not isinstance(tree, dict):
        return {"codebook": np.asarray(tree.codebook)}
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    return np.asarray(tree)


def smoke_params():
    """(reference cfg, reference params, numpy params) at PRNGKey(1)."""
    cfg = smoke_config(vqt=True)
    params = jax.device_get(T.init_params(jax.random.PRNGKey(1), cfg))
    return cfg, params, params_to_numpy(params)
