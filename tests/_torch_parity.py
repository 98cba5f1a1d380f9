"""Shared fixtures for the PyTorch-port parity tests (tests/test_torch_*.py):
the reference's smoke-config weights as a nested dict of numpy arrays, the
form both packages accept (VQ-OPT's, and any architecture's)."""
import os

import jax
import numpy as np

from repro.configs import get_config
from repro.configs.vq_opt_125m import smoke_config
from repro.models import transformer as T


def share_cores_among_workers() -> None:
    """Under pytest-xdist each worker's torch would run its CPU ops on every
    core of the machine, so the workers' thread pools oversubscribe the
    cores and the small eager models' ops wait on each other's spinning
    threads. Give each worker process its share of the cores, and (through
    ``OMP_NUM_THREADS``, unless it is set) the subprocesses it starts."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers <= 1:
        return
    try:
        import torch
    except ImportError:
        return
    n = max(1, (os.cpu_count() or 1) // workers)
    os.environ.setdefault("OMP_NUM_THREADS", str(n))
    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))


# every xdist worker collects (imports) every test module, so this runs in
# each worker that runs any test
share_cores_among_workers()


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


def arch_params(name: str, vqt: bool = False, cfg=None):
    """(reference cfg, reference params, numpy params) of architecture
    ``name``'s smoke config (or ``cfg``) at PRNGKey(1)."""
    cfg = cfg if cfg is not None else get_config(name, smoke=True, vqt=vqt)
    params = jax.device_get(T.init_params(jax.random.PRNGKey(1), cfg))
    return cfg, params, params_to_numpy(params)
