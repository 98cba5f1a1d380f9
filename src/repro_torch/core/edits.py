"""Edit scripts over token sequences (paper §3.3, §4).

Copy of ``repro/core/edits.py`` (framework-free). Atomic edits are replace
/ insert / delete of a single token. Offline revisions are aligned with
difflib to produce a minimal edit script.
"""
from __future__ import annotations

import difflib
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class Edit:
    op: str  # 'replace' | 'insert' | 'delete'
    pos: int  # position in the *current* sequence
    token: int = -1  # new token for replace/insert

    def __post_init__(self):
        assert self.op in ("replace", "insert", "delete"), self.op


def apply_edit(tokens: Sequence[int], e: Edit) -> list[int]:
    t = list(tokens)
    if e.op == "replace":
        t[e.pos] = e.token
    elif e.op == "insert":
        t.insert(e.pos, e.token)
    else:
        del t[e.pos]
    return t


def apply_edits(tokens: Sequence[int], edits: Iterable[Edit]) -> list[int]:
    t = list(tokens)
    for e in edits:
        t = apply_edit(t, e)
    return t


def align(old: Sequence[int], new: Sequence[int]) -> list[tuple]:
    """difflib opcodes aligning ``old`` against ``new``."""
    sm = difflib.SequenceMatcher(a=list(old), b=list(new), autojunk=False)
    return sm.get_opcodes()


def edit_script(old: Sequence[int], new: Sequence[int],
                opcodes: Optional[list] = None) -> list[Edit]:
    """Minimal-ish edit script old -> new, as a sequence of atomic edits whose
    positions refer to the sequence state *at the time of application*.
    Pass precomputed ``align(old, new)`` opcodes to skip the alignment."""
    if opcodes is None:
        opcodes = align(old, new)
    edits: list[Edit] = []
    shift = 0  # cumulative position shift from edits of *previous* opcodes
    for tag, i1, i2, j1, j2 in opcodes:
        if tag == "equal":
            continue
        if tag == "replace":
            common = min(i2 - i1, j2 - j1)
            for k in range(common):
                edits.append(Edit("replace", i1 + k + shift, int(new[j1 + k])))
            # deletes within a run all land on the same (post-shift) position
            for _ in range(i2 - i1 - common):
                edits.append(Edit("delete", i1 + common + shift))
            # inserts within a run advance by one per inserted token
            for k in range(j2 - j1 - common):
                edits.append(
                    Edit("insert", i1 + common + k + shift, int(new[j1 + common + k]))
                )
            shift += (j2 - j1) - (i2 - i1)
        elif tag == "delete":
            for _ in range(i2 - i1):
                edits.append(Edit("delete", i1 + shift))
            shift -= i2 - i1
        elif tag == "insert":
            for k in range(j2 - j1):
                edits.append(Edit("insert", i1 + k + shift, int(new[j1 + k])))
            shift += j2 - j1
    return edits


def random_atomic_edit(rng: np.random.Generator, tokens: Sequence[int], vocab: int,
                       ops=("replace", "insert", "delete")) -> Edit:
    op = ops[rng.integers(len(ops))]
    n = len(tokens)
    if op == "replace":
        return Edit("replace", int(rng.integers(n)), int(rng.integers(vocab)))
    if op == "insert":
        return Edit("insert", int(rng.integers(n + 1)), int(rng.integers(vocab)))
    return Edit("delete", int(rng.integers(n)))


def random_revision(
    rng: np.random.Generator,
    tokens: Sequence[int],
    vocab: int,
    edit_fraction: float,
    ops=("replace", "insert", "delete"),
) -> list[int]:
    """Produce a new revision by applying ~edit_fraction*n atomic edits at
    clustered locations (Wikipedia edits are bursty, not uniform)."""
    t = list(tokens)
    n_edits = max(1, int(round(edit_fraction * len(t))))
    # Bursty: pick a handful of cluster centers, edits near them.
    n_clusters = max(1, min(n_edits, int(rng.integers(1, 4))))
    centers = rng.integers(0, max(1, len(t)), size=n_clusters)
    for i in range(n_edits):
        c = int(centers[i % n_clusters])
        pos = int(np.clip(c + rng.integers(-8, 9), 0, max(0, len(t) - 1)))
        op = ops[rng.integers(len(ops))]
        if op == "replace" and len(t) > 0:
            t[pos] = int(rng.integers(vocab))
        elif op == "insert":
            t.insert(pos, int(rng.integers(vocab)))
        elif op == "delete" and len(t) > 1:
            del t[pos]
    return t
