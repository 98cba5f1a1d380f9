"""The serving mesh of the port — ``repro/launch/mesh.py:make_serving_mesh``
on PyTorch.

A mesh here is a plain list of ``torch.device``: the document axis of every
``BatchedJitEngine`` dispatch splits into one contiguous block of rows per
entry. The function touches no device state until it is called.
"""
from __future__ import annotations

from typing import Optional


def make_serving_mesh(n_devices: Optional[int] = None) -> list:
    """``[cuda:0, ..., cuda:k-1]``: the first ``n_devices`` visible CUDA
    devices (default: all of them). Raises when ``n_devices`` is below 1 or
    above ``torch.cuda.device_count()``, so without a GPU it always raises:
    it never returns CPU devices. Tests that want k > 1 blocks on one
    machine pass an explicit list instead (``["cpu"] * 4``,
    ``["cuda:0"] * 2``)."""
    import torch

    count = torch.cuda.device_count()
    k = count if n_devices is None else int(n_devices)
    if not 1 <= k <= count:
        raise ValueError(
            f"serving mesh of {k} devices, but only {count} CUDA devices visible")
    return [torch.device("cuda", i) for i in range(k)]
