"""The serving path's host spans (``repro_torch/serving/spans.py``): the
ring (bounded, counting what it overwrote, refusing a query over a lost
interval), self times, ``at``, per-thread parent stacks; the spans a
smoke stream through ``BatchServer`` records, with grows, defrags,
overflows and suggestion refreshes forced; and the benchmark's readers of
them (``portbench/metrics/``), which read a number with the recorder
present and nothing without it, as against a program that lacks it."""
import math
import sys
import threading
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT), str(ROOT / "portbench" / "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import _smoke  # noqa: E402
from _torch_parity import smoke_params  # noqa: E402
from portbench import bench  # noqa: E402
from repro_torch.configs.vq_opt_125m import smoke_config as port_smoke  # noqa: E402
from repro_torch.serving import spans  # noqa: E402
from repro_torch.serving.batch_server import BatchServer  # noqa: E402
# the stream that forces a grow, a defrag and an overflow fallback
from test_torch_batch_server import DOCS, SERVER, _stream  # noqa: E402


# ---------------------------------------------------------------- the ring


def test_the_ring_is_bounded_and_counts_what_it_overwrote():
    ring = spans.Ring(4)
    t0 = time.perf_counter()
    for i in range(10):
        with ring.span("s", i):
            pass
    kept = ring._kept()
    assert [s.key for s in kept] == [6, 7, 8, 9]
    assert [s.index for s in kept] == [6, 7, 8, 9]
    assert ring.overwritten == 6
    # span 5, the newest overwritten, opened after t0 and before span 6
    with pytest.raises(spans.SpansLost):
        ring.between(t0, time.perf_counter())
    with pytest.raises(spans.SpansLost):
        ring.at(t0)
    assert [s.key for s in ring.between(kept[0].start, time.perf_counter())] == [6, 7, 8, 9]
    assert ring.at(kept[2].start).key == 8


def test_a_span_open_while_overwritten_leaves_no_end_in_another_span():
    ring = spans.Ring(2)
    with ring.span("long"):
        for _ in range(3):
            with ring.span("short"):
                pass
    assert ring.overwritten == 2
    assert [s.name for s in ring._kept()] == ["short", "short"]
    assert all(s.end >= s.start for s in ring._kept())


def test_between_keeps_closed_spans_lying_wholly_inside():
    ring = spans.Ring(16)
    with ring.span("outer", "k"):
        a = time.perf_counter()
        with ring.span("inner", "k"):
            pass
        b = time.perf_counter()
        assert [s.name for s in ring.between(a, b)] == ["inner"]  # outer is open
    got = ring.between(0.0, time.perf_counter())
    assert [s.name for s in got] == ["outer", "inner"]
    outer, inner = got
    assert outer.parent == -1 and inner.parent == outer.index
    assert outer.start <= inner.start <= inner.end <= outer.end
    assert outer.key == inner.key == "k"


def test_a_span_ended_by_an_exception_is_recorded():
    ring = spans.Ring(8)
    with pytest.raises(KeyError):
        with ring.span("outer"):
            with ring.span("fails"):
                raise KeyError("x")
    got = ring.between(0.0, time.perf_counter())
    assert [s.name for s in got] == ["outer", "fails"]
    with ring.span("next"):
        pass
    assert ring.between(0.0, time.perf_counter())[-1].parent == -1  # the stack unwound


def _span(name, start, end, parent, index):
    return spans.Span(name, start, end, parent, None, index)


def test_self_seconds_subtracts_the_children_present():
    tree = [_span("flush", 0.0, 10.0, -1, 0), _span("step", 1.0, 9.0, 0, 1),
            _span("take", 1.0, 2.0, 1, 2), _span("dispatch", 3.0, 8.0, 1, 3),
            _span("wait", 4.0, 7.0, 3, 4), _span("dispatch", 8.0, 9.0, 1, 5)]
    assert spans.self_seconds(tree) == {"flush": 2.0, "step": 1.0, "take": 1.0,
                                        "dispatch": 3.0, "wait": 3.0}
    assert sum(spans.self_seconds(tree).values()) == 10.0
    # a child left out of the list is not subtracted
    assert spans.self_seconds(tree[:4])["dispatch"] == 5.0


def test_at_names_the_innermost_open_span():
    ring = spans.Ring(16)
    with ring.span("outer"):
        with ring.span("inner"):
            t_inner = time.perf_counter()
        t_outer = time.perf_counter()
        assert ring.at(t_outer).name == "outer"  # still open
    t_after = time.perf_counter()
    assert ring.at(t_inner).name == "inner"
    assert ring.at(t_outer).name == "outer"
    assert ring.at(t_after) is None
    assert spans.Ring(4).at(t_after) is None


def test_parent_stacks_are_per_thread():
    ring = spans.Ring(64)
    barrier = threading.Barrier(4)
    errors = []

    def work(tag):
        try:
            with ring.span("outer", tag):
                barrier.wait(timeout=10)
                with ring.span("inner", tag):
                    barrier.wait(timeout=10)
        except Exception as e:  # noqa: BLE001 — reported by the assert below
            errors.append(e)
    threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    got = ring.between(0.0, time.perf_counter())
    by_index = {s.index: s for s in got}
    inner = [s for s in got if s.name == "inner"]
    assert len(inner) == 4 and len(got) == 8
    for s in inner:
        assert by_index[s.parent].name == "outer" and by_index[s.parent].key == s.key


# ------------------------------------------------- spans of a smoke stream

@pytest.fixture(scope="module")
def served():
    """A smoke stream with standing suggestions: (server, its spans)."""
    cfg, _, np_params = smoke_params()
    srv = BatchServer(np_params, port_smoke(), device="cpu", **SERVER)
    t0 = time.perf_counter()
    srv.open_documents({k: list(v) for k, v in DOCS.items()})
    for did in DOCS:
        srv.submit_suggest(did, 4)
    for batch in _stream(cfg.vocab):
        for did, e in batch:
            srv.submit_edit(did, e)
        srv.flush()
    return srv, spans.between(t0, time.perf_counter())


def _children(got, parent, name):
    return [s for s in got if s.parent == parent.index and s.name == name]


def test_the_stream_forced_every_slow_path_and_each_is_a_span(served):
    srv, got = served
    st = srv.stats
    assert st.grows >= 1 and st.defrags >= 1 and st.overflows >= 1
    assert st.suggest_refreshes >= 1 and st.suggest_headroom_defrags == 0
    count = lambda name: sum(s.name == name for s in got)  # noqa: E731
    assert count("grow") == st.grows and count("defrag") == st.defrags
    assert count("overflow") == st.overflows
    assert count("refresh") == st.suggest_refreshes
    assert count("dispatch") == st.batch_steps
    assert count("flush") == len(_stream(port_smoke().vocab))
    assert count("reingest") == st.full_forwards - len(DOCS)  # less the ingests


def test_each_span_sits_under_its_layer(served):
    _, got = served
    by_index = {s.index: s for s in got}
    parent = {"step": {"flush"}, "take": {"step"}, "dispatch": {"step"},
              "gather": {"dispatch"}, "issue": {"dispatch"}, "wait": {"dispatch"},
              "scatter": {"dispatch"}, "refresh": {"step", "flush"},
              "export": {"refresh"}, "prefill": {"refresh"}, "decode": {"refresh"},
              "reingest": {"overflow", "grow", "defrag"}}
    for s in got:
        if s.name == "flush":
            assert s.parent not in by_index
        elif s.name in ("overflow", "grow", "defrag"):
            assert by_index[s.parent].name in ("take", "scatter", "refresh"), s
        else:
            assert by_index[s.parent].name in parent[s.name], s
    for d in (s for s in got if s.name == "dispatch"):
        assert len(_children(got, d, "issue")) == 1 and len(_children(got, d, "wait")) == 1
        assert len(_children(got, d, "gather")) == 1 and len(_children(got, d, "scatter")) == 1
    for r in (s for s in got if s.name == "refresh"):
        assert r.key in DOCS
        for name in ("export", "prefill", "decode"):
            assert len(_children(got, r, name)) == 1, (r, name)


def test_self_times_under_a_flush_sum_to_its_duration(served):
    _, got = served
    by_index = {s.index: s for s in got}

    def root(s):
        while s.parent in by_index:
            s = by_index[s.parent]
        return s
    for f in (s for s in got if s.name == "flush"):
        tree = [s for s in got if root(s).index == f.index]
        total = sum(spans.self_seconds(tree).values())
        assert math.isclose(total, f.end - f.start, abs_tol=1e-6 * len(tree)), f
        assert all(s.key == f.key for s in tree if s.name in ("step", "take", "dispatch"))


# ----------------------------------------------------- the benchmark's readers

EDITS = ("take_share.edits", "state_copy_share.edits", "issue_share.edits",
         "wait_share.edits", "fallback_share.edits")
ASSIST = ("refresh_wait_ms.assist", "refresh_export_ms.assist",
          "refresh_prefill_ms.assist", "refresh_decode_ms.assist")


def _driven(mix, kw):
    """A smoke run of the cell's driver, with a trace stub around it: the
    profiler's start and span on the host clock, as a traced run gives."""
    ctx = _smoke.context("vq-opt-125m", mix, **kw)
    t0 = time.perf_counter()
    out = bench.driver(ctx.traffic).run(ctx)
    out.obs["trace"] = dict(t0=t0, window_s=time.perf_counter() - t0)
    assert out.correct, out.checks
    return out.obs


@pytest.fixture(scope="module")
def driven():
    return {"edits": _driven("edits", dict(_smoke.EDITS, docs=8)),
            "assist": _driven("assist", _smoke.ASSIST)}


@pytest.mark.parametrize("name", EDITS + ASSIST)
def test_a_reader_reads_the_spans_and_nothing_without_the_recorder(driven, monkeypatch, name):
    obs = driven["edits" if name in EDITS else "assist"]
    read = bench.reader(name).read
    value = read(obs)
    assert isinstance(value, float) and value >= 0.0 and math.isfinite(value), value
    assert read({}) is None
    assert read({k: v for k, v in obs.items() if k != "trace"}) is None
    # the parent's case: a program with no recorder
    monkeypatch.delitem(sys.modules, "repro_torch.serving.spans")
    assert read(obs) is None


def test_the_edit_shares_and_the_layers_above_them_make_the_whole_flush(driven):
    obs = driven["edits"]
    shares = sum(bench.reader(n).read(obs) for n in EDITS)
    tr = obs["trace"]
    got = spans.between(tr["t0"], tr["t0"] + tr["window_s"])
    selfs = spans.self_seconds(got)
    base = sum(s.end - s.start for s in got if s.name == "flush")
    rest = 100.0 * sum(selfs.get(n, 0.0) for n in ("flush", "step", "dispatch")) / base
    assert shares + rest == pytest.approx(100.0, abs=1.0)
    assert 0.0 < bench.reader("issue_share.edits").read(obs) < 100.0
