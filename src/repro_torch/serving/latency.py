"""Latency accounting for the serving SLOs (DESIGN.md §8).

Copy of ``repro/serving/latency.py`` (framework-free). ``LatencyStats`` is
a streaming accumulator of millisecond samples with percentile readout.
Exact counts/sums are kept for every sample; the percentile estimate runs
over a bounded uniform reservoir.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field

import numpy as np


@dataclass
class LatencyStats:
    """Millisecond latency accumulator with p50/p99 readout."""

    count: int = 0
    total_ms: float = 0.0
    max_ms: float = 0.0
    sample_cap: int = 8192
    samples: list = field(default_factory=list)

    def record(self, ms: float) -> None:
        ms = float(ms)
        self.count += 1
        self.total_ms += ms
        if ms > self.max_ms:
            self.max_ms = ms
        if len(self.samples) < self.sample_cap:
            self.samples.append(ms)
        else:  # uniform reservoir: each sample retained with P = cap/count
            j = random.randrange(self.count)
            if j < self.sample_cap:
                self.samples[j] = ms

    def percentile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        return float(np.percentile(np.asarray(self.samples), q))

    @property
    def p50(self) -> float:
        return self.percentile(50.0)

    @property
    def p99(self) -> float:
        return self.percentile(99.0)

    @property
    def mean_ms(self) -> float:
        return self.total_ms / max(self.count, 1)

    def summary(self) -> dict:
        """JSON-ready snapshot (benchmark emissions)."""
        return {"count": self.count, "mean_ms": self.mean_ms,
                "p50_ms": self.p50, "p99_ms": self.p99, "max_ms": self.max_ms}
