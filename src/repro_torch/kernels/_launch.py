"""What every kernel wrapper does around a launch: bind a C launcher from
its library (``_build.load``), check the tensors it is given, and raise
when the launch is refused.

Wrappers dispatch on the device of their inputs: CPU tensors run the plain
PyTorch version (that is how the tests run) and CUDA tensors launch the
hand-written kernel or raise. Nothing falls back from the card to the plain
version. ``meta`` tensors (the dry run's stand-ins) launch nothing: the
wrapper returns empty outputs of the kernel's shapes and hands the kernel's
operations and bytes to ``meta_work``.
"""
from __future__ import annotations

import ctypes

import torch

_fns: dict = {}

PTR, INT, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def bind(lib_name: str, fn_name: str, argtypes: list):
    """The C launcher ``fn_name`` of ``csrc/<lib_name>.cu`` (built and loaded
    on first use), returning an int CUDA error code."""
    fn = _fns.get((lib_name, fn_name))
    if fn is None:
        from repro_torch.kernels import _build

        fn = getattr(_build.load(lib_name), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(lib_name, fn_name)] = fn
    return fn


# the dry run's counter: called as META_COUNTER(name, flops, nbytes) for each
# kernel call on meta tensors (``launch.dryrun`` sets it while it counts)
META_COUNTER = None


def meta_work(name: str, flops: float, nbytes: float) -> None:
    """A kernel call on meta tensors: its operations and compulsory bytes
    (the bound formulas of PERF.md section 6) to the dry run's counter."""
    if META_COUNTER is not None:
        META_COUNTER(name, flops, nbytes)


def require_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {t.device}")


def check(name: str, t: torch.Tensor, shape: tuple, device,
          dtype=torch.float32) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_of(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_aligned(**tensors) -> None:
    """Raise unless every tensor starts on a 16-byte boundary (kernels that
    move rows in 16-byte chunks)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


# Arrival counts of kernels whose last CTA of a group finishes the group's
# work: zero between launches (that CTA resets its count). One buffer per
# (device, stream), so launches on two streams never share a count. A buffer
# a launch has used is never freed, so a captured CUDA graph cannot keep a
# pointer the allocator has handed out again.
_COUNTS: dict = {}
_RETIRED: list = []


def arrival_counts(device, size: int) -> torch.Tensor:
    """At least ``size`` zeroed int32 counts for a launch on the current
    stream of ``device``."""
    key = (device, stream_of(device))
    buf = _COUNTS.get(key)
    if buf is None or buf.numel() < size:
        if buf is not None:
            _RETIRED.append(buf)
        buf = torch.zeros(max(size, 4096), dtype=torch.int32, device=device)
        _COUNTS[key] = buf
    return buf


def raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
