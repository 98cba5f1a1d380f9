"""Build and load the port's hand-written CUDA kernels.

Every ``src/repro_torch/csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface, under
``build/repro_torch_kernels/<hash>/`` at the repository root, where the hash
covers the sources and the flags. All sources compile in parallel (one
``nvcc`` each, all started together) on first use; later calls in the same
process reuse the loaded libraries and later processes reuse the files.
The libraries are loaded with ``ctypes``: no PyTorch headers are compiled,
so a build takes seconds.

Nothing here runs at import time — the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels cannot be built")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, float]:
    """Compile every source whose library is missing, all in parallel.
    Returns {source name: seconds} for the sources compiled by this call
    and raises with the compiler's output if any compile fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in _sources():
        lib = out_dir / f"lib{src.stem}.so"
        if lib.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, lib, tmp, proc, time.perf_counter()))
    seconds, failures = {}, []
    for src, lib, tmp, proc, t0 in jobs:
        log, _ = proc.communicate()
        seconds[src.name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{src.name}:\n{log}")
            os.unlink(tmp)
            continue
        os.replace(tmp, lib)  # atomic: a half-written library is never loaded
        (out_dir / f"{src.stem}.ptxas.txt").write_text(log)  # registers, spills
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first use)."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_dir() / f"lib{name}.so"
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
