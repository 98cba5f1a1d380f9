"""Persistent kernel build cache — ``repro/common/compile_cache.py`` on the
port.

The reference points jax's on-disk compilation cache at a directory so
compiled steps survive process restarts. The port compiles nothing per
step: its hand-written kernels are built once by ``nvcc``, one shared
library a source, under ``kernels._build.BUILD_ROOT/<hash>/`` (the hash
covers the sources and the flags), and later processes load the files.
``enable_persistent_compilation_cache`` points ``BUILD_ROOT`` at a
directory of the caller's (or of ``$REPRO_COMPILE_CACHE_DIR``), so
builds outlive a checkout's ``build/`` and processes that share the
directory (fleet workers, CI runs) build each source once. It is opt-in,
as in the reference: with neither an argument nor the variable it returns
None and ``build/repro_torch_kernels/`` stays the default.

Idempotent: a repeat call with the same directory changes nothing. A call
with another directory re-points later builds and loads; libraries a
process has already loaded stay loaded (``ctypes`` keeps them mapped), so
they are not rebuilt in the new directory until a new process loads them.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

ENV_VAR = "REPRO_COMPILE_CACHE_DIR"

_enabled_dir: Optional[str] = None


def enable_persistent_compilation_cache(cache_dir: Optional[str] = None) -> Optional[str]:
    """Point the kernel build cache at ``cache_dir`` (or
    ``$REPRO_COMPILE_CACHE_DIR`` when None). Returns the directory in use,
    or None when neither names one — the feature is off, not an error, so
    callers may thread the flag unconditionally."""
    global _enabled_dir
    cache_dir = cache_dir or os.environ.get(ENV_VAR) or None
    if cache_dir is None:
        return None
    cache_dir = os.path.abspath(os.path.expanduser(cache_dir))
    if _enabled_dir == cache_dir:
        return cache_dir
    from repro_torch.kernels import _build

    os.makedirs(cache_dir, exist_ok=True)
    _build.BUILD_ROOT = Path(cache_dir)
    _enabled_dir = cache_dir
    return cache_dir
