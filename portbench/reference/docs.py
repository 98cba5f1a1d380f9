"""What a served document is after a stream of edits, worked out again from
the stream alone: its tokens in sequence order and the position id of
each token.

The position ids follow the paper's gapped allocation (arXiv:2307.14988
§3.3): a document of n tokens starts at ids ``(i + 1)·pool // (n + 1)``;
an inserted token takes the midpoint of its neighbours' ids (the pool's
ends bound the first and last gap); a deleted token frees its id; when an
insertion finds no free id between its neighbours, every id is re-spread
evenly first (a defragmentation). A suggestion that would run past the
pool re-spreads the ids too (``headroom``). This is a frozen copy of the
rule the program's serving allocator states, so that a change to the
program's rule shows as a wrong answer.
"""
from __future__ import annotations

import numpy as np


def spread(n: int, pool: int) -> list:
    if n < pool:
        return [int(p) for p in (np.arange(1, n + 1, dtype=np.int64) * pool) // (n + 1)]
    return [int(p) for p in (np.arange(n, dtype=np.int64) * pool) // max(n, 1)]


class Document:
    """Tokens and position ids of one document under replace / insert /
    delete edits given in sequence coordinates."""

    def __init__(self, tokens, pool: int):
        self.tokens = [int(t) for t in tokens]
        self.pool = int(pool)
        self.positions = spread(len(self.tokens), self.pool)
        self.defrags = 0

    def __len__(self) -> int:
        return len(self.tokens)

    def defragment(self) -> None:
        self.positions = spread(len(self.positions), self.pool)
        self.defrags += 1

    def apply(self, op: str, pos: int, tok: int) -> None:
        if op == "replace":
            self.tokens[pos] = int(tok)
        elif op == "insert":
            lo = self.positions[pos - 1] if pos > 0 else -1
            hi = self.positions[pos] if pos < len(self.positions) else self.pool
            if hi - lo <= 1:
                self.defragment()
                lo = self.positions[pos - 1] if pos > 0 else -1
                hi = self.positions[pos] if pos < len(self.positions) else self.pool
                if hi - lo <= 1:
                    raise ValueError("the position pool is full")
            self.positions.insert(pos, (lo + hi) // 2)
            self.tokens.insert(pos, int(tok))
        elif op == "delete":
            del self.positions[pos]
            del self.tokens[pos]
        else:
            raise ValueError(op)

    def headroom(self, n_new: int) -> None:
        """Before a continuation of ``n_new`` ids after the last token: re-spread
        when they would pass the pool's last id."""
        if self.pool - 1 - self.positions[-1] < n_new:
            self.defragment()
