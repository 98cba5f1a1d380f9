"""Device grids of the port — ``repro/launch/mesh.py`` on PyTorch.

``make_serving_mesh`` gives the serving stack its mesh: a plain list of
``torch.device``, the document axis of every ``BatchedJitEngine`` dispatch
split into one contiguous block of rows per entry.

``Grid`` is the port's ``jax.sharding.Mesh``: a numpy object array of
``torch.device`` with named axes. ``make_mesh`` is ``jax.make_mesh``;
``make_host_mesh`` and ``make_production_mesh`` are the reference's grids.
An entry may repeat a device (``["cpu"] * 4`` in tests, ``["cuda:0"] * 4``
on one card): the grid then plans and runs every block on that device.
Nothing touches device state until a function is called.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class Grid:
    """Named axes over a numpy array of ``torch.device`` (row-major)."""

    def __init__(self, devices: np.ndarray, axis_names: tuple):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        """{axis name: size}, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Grid({self.shape}, {sorted({str(d) for d in self.devices.flat})})"


def _indexed(dev):
    """``cuda`` as ``cuda:0``, so a grid entry equals the device of the
    tensors made on it."""
    import torch

    return torch.device(dev.type, 0) if dev.type == "cuda" and dev.index is None else dev


def make_mesh(shape, axis_names, devices=None) -> Grid:
    """``jax.make_mesh``: the first prod(shape) of ``devices`` (default:
    every visible CUDA device) laid out row-major. Raises a ``ValueError``
    naming the counts when fewer are given; never shrinks the grid."""
    import torch

    shape = tuple(int(s) for s in shape)
    need = int(np.prod(shape))
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_indexed(torch.device(d)) for d in devices]
    if len(devices) < need:
        raise ValueError(f"a {'x'.join(map(str, shape))} grid needs {need} devices, "
                         f"but only {len(devices)} are visible")
    arr = np.empty(need, dtype=object)
    arr[:] = devices[:need]
    return Grid(arr.reshape(shape), tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Grid:
    """The reference's production grids: (16, 16) over ("data", "model"),
    or (2, 16, 16) over ("pod", "data", "model") with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_host_mesh(device="cuda") -> Grid:
    """A 1x1 ("data", "model") grid of one device (the reference's
    single-device mesh for smoke runs)."""
    return make_mesh((1, 1), ("data", "model"), [device])


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
