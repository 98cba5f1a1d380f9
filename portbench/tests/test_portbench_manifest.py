"""``BENCHMARK.json`` against the benchmark's contract and its files: every
name it gives resolves to a file of its own, names and units keep to their
characters, every cell reports what its per-layer metrics move, a cell
added as files and entries is found without editing a file, and card-only
tests decide at run time."""
from __future__ import annotations

import ast
import json
import re
import shutil

import pytest

import _smoke
from portbench import bench

ROOT = _smoke.ROOT
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
METRIC_KEYS = {"name", "unit", "better", "source"}


def line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(M) == KEYS
    assert M["command"] == ["python3", "portbench/run.py"]
    assert M["paths"] == ["portbench"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in M[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and line(c["why"])
        assert line(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and line(w["why"])
        assert w["chips"] == 1 and NAME.match(w["traffic"])
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"} and line(m["layer"])


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e


def test_every_name_resolves_to_its_own_file():
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    for c in M["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        for k in c["reduced"]:
            assert k in cfg, k
    for w in M["workloads"]:
        assert w["config"] in {c["name"] for c in M["configs"]}
        tr = ROOT / "portbench" / "traffic" / f"{w['traffic']}.json"
        drv = json.loads(tr.read_text())["driver"]
        assert (ROOT / "portbench" / "drivers" / f"{drv}.py").exists()
    for m in M["per_layer"]:
        assert hasattr(bench.reader(m["name"]), "read"), m["name"]


@pytest.mark.parametrize("w", M["workloads"], ids=lambda w: w["name"])
def test_each_cell_reports_what_its_metrics_move(w):
    spec = bench.cell(w["name"])
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["per_layer"], "a cell reports at least one per-layer metric"
    for m in spec["per_layer"]:
        assert m["moves"] in e2e, (w["name"], m["name"])


def test_readers_read_nothing_from_nothing():
    for m in M["per_layer"]:
        assert bench.reader(m["name"]).read({}) is None, m["name"]


ROOFLINES = {"fused_step_roofline": ("fused_step", 1),
             "vq_assign_roofline.prefill": ("vq_assign", 1),
             "attn_bwd_roofline.train": ("attn_bwd", 2)}


@pytest.mark.parametrize("name", sorted(ROOFLINES))
def test_a_roofline_reader_fails_on_launches_it_did_not_record(name):
    key, per_call = ROOFLINES[name]
    read = bench.reader(name).read
    seen = dict(bound_s=0.002, calls=3, kernel=(0.01, 3 * per_call))
    assert read({key: seen}) == pytest.approx(20.0)
    for calls, launches in ((0, 3 * per_call), (3, 4 * per_call), (3, 0)):
        with pytest.raises(RuntimeError, match="out of the reader's sight"):
            read({key: dict(seen, calls=calls, kernel=(0.01 if launches else 0.0, launches))})
    assert read({key: dict(bound_s=0.0, calls=0, kernel=(0.0, 0))}) is None


def test_a_cell_added_as_files_is_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench")
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    tr = json.loads((root / "portbench" / "traffic" / "edits.json").read_text())
    tr.update(docs=32, len_min=128, len_max=512)
    (root / "portbench" / "traffic" / "edits-short.json").write_text(json.dumps(tr))
    m["workloads"].append({"name": "vq-opt-125m.edits-short", "config": "vq-opt-125m",
                           "traffic": "edits-short", "chips": 1, "why": "short documents"})
    for metric in m["end_to_end"] + m["per_layer"]:
        if "vq-opt-125m.edits" in metric.get("workloads", []):
            metric["workloads"].append("vq-opt-125m.edits-short")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    spec = bench.cell("vq-opt-125m.edits-short", root=root)
    assert spec["traffic"]["docs"] == 32 and spec["config"]["name"] == "vq-opt-125m"
    assert {x["name"] for x in spec["end_to_end"]} == {"edits_per_s", "setup_s"}
    assert bench.driver(spec["traffic"], root=root).run


def test_card_only_tests_decide_at_run_time():
    for path in sorted((ROOT / "portbench" / "tests").glob("test_*.py")):
        tree = ast.parse(path.read_text())
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                continue
            code = ast.unparse(node)
            assert "cuda" not in code.replace("mark.cuda", ""), (path.name, code)
        for fn in [n for n in tree.body if isinstance(n, ast.FunctionDef)]:
            if "card" in [a.arg for a in fn.args.args]:
                marks = [ast.unparse(d) for d in fn.decorator_list]
                assert "pytest.mark.cuda" in marks, (path.name, fn.name)
