"""Capacity bucketing shared by the serving scheduler and the kernels.

Copy of ``repro/common/bucketing.py`` (framework-free). Every dynamic
quantity in the static-shape path (edit count, dirty-row count, document
length, batch size) is rounded up to a power-of-two bucket so the set of
step shapes stays O(log) in each dimension.
"""
from __future__ import annotations


def next_pow2(n: int, minimum: int = 1) -> int:
    """The smallest power-of-two multiple of ``minimum`` >= ``n``
    (``minimum`` itself must be a power of two for pow2 results)."""
    c = max(int(minimum), 1)
    while c < n:
        c *= 2
    return c


def capacity_class(n_cap: int, minimum: int, step: int = 4) -> int:
    """Padded device capacity for a logical slot capacity ``n_cap``: the
    smallest ``minimum * step**k`` >= ``n_cap`` (DESIGN.md §9). One padded
    shape serves a range of logical capacities; ``step=2`` is the plain
    power-of-two lattice."""
    if step < 2:
        raise ValueError("capacity_class step must be >= 2")
    c = max(int(minimum), 1)
    while c < n_cap:
        c *= step
    return c
