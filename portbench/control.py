"""The readings a cell's limits are set from, on the card.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 --seconds 5 \\
        [--control-seeds 1,2,3]

For each seed, one run of the cell with a short window at the cell's own
load and sizes, in one process: the numbers its program gives (the lower
readings), and, for the control seeds, the same numbers of the plain
reference put in the program's place and computed in the next precision
below the configuration's (``tf32``: float32 products on the TF32 tensor
cores), judged the same way (the upper readings), and the readings of the
faults the driver plants in the reference (``fault_*``). One JSON line a
seed.
The benchmark's own runs never run this.
"""
import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import bench  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args()
    bench.setup_env()
    spec = bench.cell(args.workload)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    drv = bench.driver(spec["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = bench.Context(workload=args.workload, seed=seed, seconds=args.seconds, trace=False,
                            config=spec["config"], traffic=spec["traffic"], device="cuda",
                            control="tf32" if seed in controls else None)
        out = drv.run(ctx)
        faults = {k: v for k, v in out.obs.items() if k.startswith("fault_")}
        print(json.dumps(dict(seed=seed, correct=out.correct, e2e=out.e2e,
                              program=out.obs.get("judged"), control=out.obs.get("control"),
                              faults=faults, power=bench.power_limit())), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
