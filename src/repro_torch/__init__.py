"""PyTorch / CUDA port of the incremental VQ-Transformer serving stack.

``repro_torch`` mirrors ``repro`` (the JAX/Pallas reference package) module
for module, under the same file names, so each file names its counterpart.
It imports ``torch`` and never ``jax``, and nothing of ``repro``: the
framework-free host code it needs is copied here.

Entry points (``BatchServer``, ``BatchedJitEngine``, ``JitIncrementalEngine``,
``init_params``) take ``device=`` and default to ``"cuda"``; on a machine
without a GPU that default raises instead of falling back to the CPU. Tests
pass ``device="cpu"``, where every kernel wrapper runs its plain PyTorch
version.

Importing the package imports nothing heavy (``torch`` loads with the
modules that use it), so a fleet worker can claim its RPC pipe first.
"""
from __future__ import annotations


def resolve_device(device):
    """The ``torch.device`` an entry point runs on. ``"cuda"`` without a
    visible GPU is an error, never a silent move to the CPU."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    return dev
