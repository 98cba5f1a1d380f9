"""The benchmark of the PyTorch / CUDA port, one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Finds the cell in ``BENCHMARK.json``, builds what its configuration and
traffic mix ask for on the card, warms up, measures for ``--seconds``,
checks what the timed path produced against the plain reference, and
prints one JSON line: with ``--trace 0`` the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics (a traced run). The numbers
compared with their limits are the last lines on standard error and the
``checks`` key of the line. Exits non-zero, with no line, when the card or
the program is missing or a module of JAX was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import bench  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    bench.setup_env()
    spec = bench.cell(args.workload)
    chips = spec["entry"]["chips"]

    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = bench.Context(workload=args.workload, seed=args.seed, seconds=args.seconds,
                        trace=bool(args.trace), config=spec["config"], traffic=spec["traffic"],
                        device="cuda", t_start=T_START)
    out = bench.driver(spec["traffic"]).run(ctx)
    bad = bench.forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    metrics = {}
    if args.trace:
        for m in spec["per_layer"]:
            value = bench.reader(m["name"]).read(out.obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": out.e2e[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device, "power": bench.power_limit()}
    if args.trace and out.trace is not None:
        device["busy_s"] = out.trace["busy_s"]
        device["window_s"] = out.trace["window_s"]
        line["breakdown"] = out.trace["breakdown"]
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in out.checks}
    for name, v, lim in out.checks:
        print(f"check {name}: {v!r} (limit {lim!r}){'' if v <= lim else ' FAILED'}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
