"""The program's host spans in a traced run, for the readers under
``metrics/``.

The recorder (``repro_torch.serving.spans``) is found in ``sys.modules``
and never imported: a program without it, as an older checkout is, leaves
the span metrics out of the line instead of failing the run. Every reader
takes the spans lying wholly in the traced span, ``[t0, t0 + window_s]``
of ``obs["trace"]`` on the host clock the spans share; a round lies wholly
inside it. Each helper returns None where the recorder, the trace or the
spans a metric divides by are absent.
"""
from __future__ import annotations

import statistics
import sys

MODULE = "repro_torch.serving.spans"


def traced(obs: dict):
    """(recorder module, the spans of the traced span), or None."""
    rec, tr = sys.modules.get(MODULE), obs.get("trace")
    if rec is None or not tr:
        return None
    return rec, rec.between(tr["t0"], tr["t0"] + tr["window_s"])


def flush_share(obs: dict, names: tuple, whole: bool = False):
    """The spans named ``names`` as a share of the ``flush`` spans' time, in
    %: their self time, or with ``whole`` their whole time, children
    included."""
    got = traced(obs)
    if got is None:
        return None
    rec, spans = got
    base = sum(s.end - s.start for s in spans if s.name == "flush")
    if not base:
        return None
    if whole:
        part = sum(s.end - s.start for s in spans if s.name in names)
    else:
        selfs = rec.self_seconds(spans)
        part = sum(selfs.get(n, 0.0) for n in names)
    return 100.0 * part / base


def refresh_ms(obs: dict, name: str):
    """The mean self ms of ``name`` spans a ``refresh`` span."""
    got = traced(obs)
    if got is None:
        return None
    rec, spans = got
    n = sum(s.name == "refresh" for s in spans)
    return 1e3 * rec.self_seconds(spans).get(name, 0.0) / n if n else None


def refresh_wait_ms(obs: dict):
    """The median over ``refresh`` spans of the ms from the start of the
    ``flush`` span that holds each to its own start."""
    got = traced(obs)
    if got is None:
        return None
    _, spans = got
    by_index = {s.index: s for s in spans}
    waits = []
    for s in spans:
        if s.name != "refresh":
            continue
        up = by_index.get(s.parent)
        while up is not None and up.name != "flush":
            up = by_index.get(up.parent)
        if up is not None:
            waits.append(1e3 * (s.start - up.start))
    return statistics.median(waits) if waits else None
