"""Time variants of the ``gated_attention`` backward kernels side by side on
one card.

    python3 tools/time_bwd_variants.py NAME=SOURCE[:-DFLAG[,-DFLAG...]] ... \
        [--shapes 96x1024,48x1024]

Each SOURCE (relative to the repository root) is a CUDA file that exports
the two launchers of ``src/repro_torch/csrc/gated_attention_bwd.cu``: that
file, or a copy of it with its design choices behind macros, kept under the
git-ignored ``build/``. Each is built with the port's nvcc flags
(``_build.NVCC_FLAGS``), ``-I src/repro_torch/csrc`` and its own ``-D``
flags, all at once, and its ptxas registers and spills printed. Then, at
each BH x n of ``--shapes``, every variant is held against the plain version
and timed by ``chip_smoke.check_gated_attention_bwd`` (dq, dk, dv within
``BWD_TOL`` of its max; device ms of the dK/dV and dQ kernels), in the order
A B ... B A, one JSON line a run. A variant named ``diag_...`` computes
something else on purpose (one TF32 product in place of three, no GELU):
its error is reported, not gated. Needs a GPU and nvcc; compare variants
only within one call.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels._launch import stream_of  # noqa: E402
from repro_torch.kernels.gated_attention import gated_attention_bwd_ref  # noqa: E402
from repro_torch.kernels.gated_attention.ops import (  # noqa: E402
    BWD_DKV_ARGTYPES, BWD_DQ_ARGTYPES,
)

OUT = ROOT / "build" / "bwd_variants"


def build(name: str, source: str, flags: list[str]) -> tuple[str, Path, list[str]]:
    """Compile one variant into ``build/bwd_variants/lib<name>.so``;
    returns the library and ptxas's register and spill lines."""
    lib = OUT / f"lib{name}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), *flags,
                           "-o", str(lib), str(ROOT / source)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    return name, lib, [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
                       if "registers" in line or "spill" in line]


def bind(lib_path: Path) -> types.SimpleNamespace:
    """A namespace with ``gated_attention_bwd_bh`` (the two launchers in
    turn, as the port's wrapper) and ``gated_attention_bwd_ref``."""
    lib = ctypes.CDLL(str(lib_path))
    dkv, dqf = lib.gated_attention_bwd_dkv_launch, lib.gated_attention_bwd_dq_launch
    dkv.argtypes, dqf.argtypes = BWD_DKV_ARGTYPES, BWD_DQ_ARGTYPES
    dkv.restype = dqf.restype = ctypes.c_int

    def bwd(q, k, v, do):
        BH, n, dh = q.shape
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        ptrs = [t.data_ptr() for t in (q, k, v, do)]
        stream = stream_of(q.device)
        if dkv(*ptrs, dk.data_ptr(), dv.data_ptr(), BH, n, dh ** -0.5, stream) or \
                dqf(*ptrs, dq.data_ptr(), BH, n, dh ** -0.5, stream):
            raise RuntimeError("a launch was refused")
        return dq, dk, dv

    return types.SimpleNamespace(gated_attention_bwd_bh=bwd,
                                 gated_attention_bwd_ref=gated_attention_bwd_ref)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("variants", nargs="+", metavar="NAME=SOURCE[:FLAGS]")
    p.add_argument("--shapes", default="96x1024,48x1024,48x128")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("time_bwd_variants: needs a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    specs = []
    for spec in args.variants:
        name, _, rest = spec.partition("=")
        source, _, flags = rest.partition(":")
        specs.append((name, source, [f for f in flags.split(",") if f]))
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(specs)) as pool:
        built = list(pool.map(lambda s: build(*s), specs))
    mods = {}
    for name, lib, ptxas in built:
        print(json.dumps({"variant": name, "ptxas": ptxas}), flush=True)
        mods[name] = bind(lib)
    print(cs.nvidia_smi(), flush=True)
    order = list(mods) + list(mods)[::-1]
    for shape in args.shapes.split(","):
        BH, n = (int(x) for x in shape.split("x"))
        for name in order:
            cs.BWD_TOL = float("inf") if name.startswith("diag_") else 1e-5
            row = cs.check_gated_attention_bwd(
                mods[name], torch.Generator(device="cuda").manual_seed(0), n, BH=BH)
            print(json.dumps({"variant": name, **{k: row[k] for k in (
                "BH", "n", "ms", "dkv_ms", "dq_ms", "plain_ms", "bound_ms", "rel_err")}}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
