"""Host spans of the serving path: where a flush's host time goes.

A span is ``(name, start, end, parent, key)`` with its ``index``, the
serial number it was opened under. Times come from ``time.perf_counter()``,
the clock a caller's own timers and a profiler's start read, so spans,
outer timers and a device trace share one time base. ``parent`` is the
index of the span open on the same thread when this one opened (-1 for
none): the stack of open spans is per thread, since
``serving.async_server`` drives the server from a worker thread. ``key``
names what the span served: the flush's serial under a flush, the
document for a refresh and its phases and for a document's slow paths.

The recorder is a ring of fixed capacity, always on: the newest
``capacity`` spans are kept, in preallocated slots, and older ones are
overwritten and counted (``Ring.overwritten``). A query over an interval
that may have held an overwritten span raises rather than answer from a
partial record. The module's ``RING`` holds 2**16 spans: an edit stream
records ~70 a second on an H100 host, so a run of ten minutes never wraps.

Spans sit at the layer boundaries of ``batch_server`` and ``suggest`` and
nowhere else: a span only reads the host clock, never the device.
"""
from __future__ import annotations

import math
import threading
import time
from collections import defaultdict
from typing import NamedTuple, Optional

CAPACITY = 1 << 16


class Span(NamedTuple):
    name: str
    start: float
    end: float  # NaN while the span is open
    parent: int  # index of the enclosing span on its thread, -1 for none
    key: object
    index: int


class SpansLost(RuntimeError):
    """The ring overwrote spans that the asked interval may have held."""


class _Open:
    """The context manager ``Ring.span`` returns."""

    __slots__ = ("ring", "name", "key", "index")

    def __init__(self, ring: "Ring", name: str, key):
        self.ring, self.name, self.key = ring, name, key

    def __enter__(self):
        self.index = self.ring._open(self.name, self.key)
        return self

    def __exit__(self, *exc):
        self.ring._close(self.index)
        return False


class Ring:
    """A fixed-capacity record of spans; see the module docstring."""

    def __init__(self, capacity: int = CAPACITY):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._index = [-1] * capacity  # the span each slot holds
        self._name = [""] * capacity
        self._start = [0.0] * capacity
        self._end = [math.nan] * capacity
        self._parent = [-1] * capacity
        self._key: list = [None] * capacity
        self._next = 0  # index of the next span opened
        self.overwritten = 0
        self._lost_start = -math.inf  # start of the newest overwritten span
        self._lost_end = -math.inf  # the latest end of one (inf: it was open)
        self._lock = threading.Lock()
        self._local = threading.local()

    def span(self, name: str, key=None) -> _Open:
        """A context manager recording one span around its block (also when
        the block raises: the time was spent)."""
        return _Open(self, name, key)

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _open(self, name: str, key) -> int:
        stack = self._stack()
        parent = stack[-1] if stack else -1
        with self._lock:
            i = self._next
            self._next = i + 1
            s = i % self.capacity
            if self._index[s] >= 0:
                self.overwritten += 1
                self._lost_start = self._start[s]
                end = self._end[s]
                self._lost_end = max(self._lost_end, math.inf if math.isnan(end) else end)
            self._index[s], self._name[s], self._parent[s], self._key[s] = i, name, parent, key
            self._end[s] = math.nan
            self._start[s] = time.perf_counter()
        stack.append(i)
        return i

    def _close(self, i: int) -> None:
        t = time.perf_counter()
        self._stack().pop()
        s = i % self.capacity
        if self._index[s] == i:  # not overwritten while it was open
            self._end[s] = t

    def _kept(self) -> list:
        """Every span the ring holds, oldest first."""
        with self._lock:
            lo = max(self._next - self.capacity, 0)
            slots = [i % self.capacity for i in range(lo, self._next)]
            return [Span(self._name[s], self._start[s], self._end[s], self._parent[s],
                         self._key[s], self._index[s]) for s in slots]

    def _lost(self, what: str) -> SpansLost:
        return SpansLost(f"{self.overwritten} spans were overwritten, the newest opened "
                         f"at {self._lost_start}: the record of {what} is partial")

    def between(self, t0: float, t1: float) -> list:
        """The closed spans lying wholly in ``[t0, t1]``, oldest first.
        Raises ``SpansLost`` where the interval may have lost spans."""
        if self._lost_start >= t0:
            raise self._lost(f"[{t0}, {t1}]")
        return [r for r in self._kept() if t0 <= r.start and r.end <= t1]

    def at(self, t: float) -> Optional[Span]:
        """The innermost span open at host time ``t`` (the latest opened of
        those that cover it, still open or closed), or None. Raises
        ``SpansLost`` where an overwritten span may have covered ``t``."""
        if self._lost_end >= t:
            raise self._lost(f"time {t}")
        for r in reversed(self._kept()):
            if r.start <= t and not r.end < t:  # NaN: still open
                return r
        return None


def self_seconds(spans) -> dict:
    """Each span's duration less what its children among ``spans`` cover,
    summed by name."""
    children = defaultdict(float)
    for s in spans:
        children[s.parent] += s.end - s.start
    out = defaultdict(float)
    for s in spans:
        out[s.name] += s.end - s.start - children.get(s.index, 0.0)
    return dict(out)


RING = Ring()
span = RING.span
between = RING.between
at = RING.at
