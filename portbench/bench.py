"""What every cell shares: finding its files by name, the run's context,
the device trace, and the result line.

The harness is driven by data. ``BENCHMARK.json`` names each cell's
configuration and traffic mix; ``configs/<config>.json`` holds the
model's sizes, ``traffic/<mix>.json`` the mix's parameters and the name of
the driver (``drivers/<driver>.py``) that serves it, and
``metrics/<metric>.py`` reads one per-layer metric from what a run
observed. A new cell, mix or metric is new files and entries, not an edit.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def setup_env() -> None:
    """The program's sources on the path; every kernel cache at a fixed
    path inside the checkout (the program builds its CUDA kernels under
    ``build/repro_torch_kernels/`` there itself); one host thread for the
    numerical libraries, so the host-bound paths are not timed against
    spinning worker threads on a shared host. Before torch is imported."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)
    os.environ.setdefault("USE_FLAX", "0")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def load_module(path: Path):
    """A module of the harness found by its file name (names may hold dots
    and dashes)."""
    spec = importlib.util.spec_from_file_location(f"portbench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str, root: Path = ROOT) -> dict:
    """The cell's entry of ``BENCHMARK.json`` with its configuration, mix
    and metrics resolved: ``config`` (dict), ``traffic`` (dict),
    ``end_to_end`` and ``per_layer`` (the metric entries it reports)."""
    m = manifest(root)
    entry = next((w for w in m["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in m["configs"] if c["name"] == entry["config"])
    mine = lambda metric: name in metric.get("workloads", [name])  # noqa: E731
    return dict(entry=entry, config=load_json(root / conf["file"]),
                traffic=load_json(root / "portbench" / "traffic" / f"{entry['traffic']}.json"),
                end_to_end=[x for x in m["end_to_end"] if mine(x)],
                per_layer=[x for x in m["per_layer"] if mine(x)],
                root=root)


def driver(traffic: dict, root: Path = ROOT):
    return load_module(root / "portbench" / "drivers" / f"{traffic['driver']}.py")


def reader(metric: str, root: Path = ROOT):
    return load_module(root / "portbench" / "metrics" / f"{metric}.py")


def forbidden_modules() -> list:
    """Loaded modules of JAX or of the JAX package, by whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def arch(cfg: dict):
    """The program's configuration object for a configuration file."""
    from repro_torch.configs.base import ArchConfig, LayerCfg, uniform_stages
    from repro_torch.core.vq import VQConfig

    vq = cfg["vqt"]
    return ArchConfig(
        name=cfg["name"], family="dense", n_layers=cfg["n_layers"], d_model=cfg["d_model"],
        n_heads=cfg["n_heads"], n_kv_heads=cfg["n_kv_heads"], d_ff=cfg["d_ff"],
        vocab=cfg["vocab"], stages=uniform_stages(LayerCfg(mixer="gqa", ffn=cfg["ffn"]),
                                                  cfg["n_layers"]),
        head_dim=cfg.get("head_dim"), norm=cfg["norm"], pos=cfg["pos"],
        rope_theta=cfg.get("rope_theta", 10000.0), max_seq=cfg["max_seq"],
        pos_pool=cfg.get("pos_pool", 0), attn_softmax=False, attn_bias=cfg["attn_bias"],
        vqt=VQConfig(n_heads=vq["n_heads"], codebook_size=vq["codebook_size"],
                     commitment_beta=vq["commitment_beta"], temperature=vq["temperature"]),
        tie_embeddings=cfg["tie_embeddings"], source=cfg["source"]).validate()


class Context:
    """One run: its arguments, the cell's files, the device, and the clock
    the set-up time is read from."""

    def __init__(self, *, workload: str, seed: int, seconds: float, trace: bool,
                 config: dict, traffic: dict, device="cuda", t_start: float | None = None,
                 control: str | None = None):
        self.workload, self.seed, self.seconds, self.trace = workload, seed, seconds, trace
        # the control (``portbench/control.py``): the precision in which the
        # reference, put in the program's place, is judged too
        self.control = control
        self.cfg, self.traffic, self.device = config, traffic, device
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.spans: list = []  # (name, t0, t1) on the host clock, traced runs only

    @property
    def cuda(self) -> bool:
        return str(self.device).startswith("cuda")

    def sync(self) -> None:
        import torch

        if self.cuda:
            torch.cuda.synchronize()

    def peak_bytes(self) -> int:
        """The process's peak of allocated device memory so far."""
        import torch

        return torch.cuda.max_memory_allocated() if self.cuda else 0

    def reset_peak(self) -> None:
        """Start the peak of allocated device memory anew from what is held now."""
        import torch

        if self.cuda:
            torch.cuda.reset_peak_memory_stats()

    def release(self) -> None:
        """Free what the program left (run once its state is dropped)."""
        import gc

        import torch

        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def now(self) -> float:
        return time.perf_counter()


class Outcome:
    """What a driver hands back: counts, end-to-end values, what the
    per-layer readers read, and the numbers compared with their limits."""

    def __init__(self):
        self.attempted = 0
        self.failed = 0
        self.e2e: dict = {}
        self.obs: dict = {}
        self.checks: list = []  # (name, value, limit): correct when value <= limit
        self.memory_peak_bytes = 0
        self.trace: dict | None = None

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks.append((name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v <= lim for _, v, lim in self.checks)


# ---------------------------------------------------------------- the trace


class DeviceTrace:
    """torch.profiler over a span of the window, device activity only (host
    records would lengthen the span and their processing outlasts a traced
    window of many thousand launches): the device's busy seconds as the sum
    of every kernel's and copy's self time (one stream), the span's wall
    seconds, each kernel name's time and count, and the idle gaps between
    device operations. A frozen copy of ``chip_smoke.profiled``'s reading,
    with the timeline kept for the gaps."""

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.prof = None
        self.result = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.ctx.sync()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ctx.sync()
        t1 = time.perf_counter()
        self.wall = t1 - self.t0
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.result = self._read()
        # seconds the harness spent stopping the profiler and reading it,
        # with the card idle: a window that holds them does less work
        self.cost = time.perf_counter() - t1
        return False

    def _read(self) -> dict:
        from torch.autograd import DeviceType

        avg = [e for e in self.prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in avg) / 1e6
        kernels = {e.key: dict(s=e.self_device_time_total / 1e6, count=e.count) for e in avg}
        events = sorted((e.time_range.start, e.time_range.end, e.name)
                        for e in self.prof.events() if e.device_type == DeviceType.CUDA)
        gaps = []
        for (s0, e0, n0), (s1, _, n1) in zip(events, events[1:]):
            if s1 > e0:
                gaps.append(((s1 - e0) / 1e6, s0 / 1e6, n0, n1))
        gaps.sort(reverse=True)
        return dict(busy_s=busy, window_s=self.wall, kernels=kernels, gaps=gaps[:10],
                    launches=len(events), t0=self.t0)


def working_seconds(obs: dict) -> float:
    """The window's seconds less those spent reading the trace inside it
    (``paused_s``, a traced run): what a share of the peak divides by."""
    return obs["window_s"] - obs.get("paused_s", 0.0)


def kernel_time(tr: dict, part: str) -> tuple[float, int]:
    """Device seconds and launches, in a trace's reading, of the kernels
    whose name holds ``part``."""
    mine = [k for name, k in tr["kernels"].items() if part in name]
    return sum(k["s"] for k in mine), sum(k["count"] for k in mine)


def roofline_share(f: dict | None, per_call: int):
    """A kernel's share of its roofline in %: the summed bounds of the calls
    the harness recorded (``f["bound_s"]``, ``f["calls"]``) over the device
    seconds of the kernel in the trace (``f["kernel"]``, from
    ``kernel_time``). None where the traced span neither launched the
    kernel nor recorded a call. Each call launches ``per_call`` kernels;
    where the trace's launches differ, the kernel ran where the harness
    did not see it (reached through another binding) or under another
    name, and the run fails rather than report a share that reads wrong."""
    if not f:
        return None
    seconds, launches = f["kernel"]
    if not launches and not f["calls"]:
        return None
    if launches != per_call * f["calls"] or not seconds:
        raise RuntimeError(f"the trace holds {launches} launches of the kernel in "
                           f"{seconds} s, the harness recorded {f['calls']} calls of "
                           f"{per_call}: the kernel is out of the reader's sight")
    return 100.0 * f["bound_s"] / seconds



def short(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0].split("<")[0][:60]


def breakdown(tr: dict, spans: list) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps named by the harness span the host was in (and the
    operation the gap followed). Device times count from the profiler's
    start, ``tr["t0"]`` on the host clock."""
    ops = sorted(tr["kernels"].items(), key=lambda kv: -kv[1]["s"])[:10]

    def host_at(t_rel: float) -> str:
        t = tr["t0"] + t_rel
        for name, a, b in spans:
            if a <= t <= b:
                return name
        return "between spans"
    gaps = [[f"{host_at(start)} after {short(n0)}", g] for g, start, n0, _ in tr["gaps"]]
    return dict(device_ops=[[short(k), v["s"]] for k, v in ops], idle_gaps=gaps)


# ---------------------------------------------------------------- the line


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"
