"""Small versions of the cells for the CPU tests: the configurations with
the smoke sizes the program's own tests use, and mixes short enough to
run in seconds. The widths change here only; the cells on the card run
the files under ``portbench/configs`` as they are."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import bench  # noqa: E402

SMOKE = dict(n_layers=2, d_model=256, n_heads=4, d_ff=512, vocab=512, max_seq=128)


def config(name: str) -> dict:
    cfg = dict(bench.load_json(ROOT / "portbench" / "configs" / f"{name}.json"))
    cfg.update(SMOKE, head_dim=64, n_kv_heads=4 if cfg["n_kv_heads"] == cfg["n_heads"] else 2)
    if cfg["pos"] == "sampled":
        cfg["pos_pool"] = SMOKE["max_seq"] * 16
    return cfg


def traffic(name: str, **kw) -> dict:
    tr = dict(bench.load_json(ROOT / "portbench" / "traffic" / f"{name}.json"))
    tr.update(kw)
    return tr


EDITS = dict(docs=6, len_min=24, len_max=90, max_batch=4, warmup_rounds=1, check_docs=4)
PREFILL = dict(lengths=[32, 64], chunk=16, batch=2, check_batches=2)
ASSIST = dict(docs=4, len_min=24, len_max=90, max_batch=4, warmup_rounds=1,
              check_suggestions=6, n_new=4)
TRAIN = dict(batch=2, seq=32)


def context(cfg_name: str, mix: str, seed: int = 7, seconds: float = 0.5, **kw):
    return bench.Context(workload=f"{cfg_name}.{mix}", seed=seed, seconds=seconds, trace=False,
                         config=config(cfg_name), traffic=traffic(mix, **kw), device="cpu")
