"""The one traffic generator: every mix under ``portbench/traffic/`` is a
file of parameters that these functions read. Everything is drawn from
the run's seed with numpy, so a seed gives the same inputs on any machine.

Every seed gets the same shapes: the same set of lengths, and for the
edit mixes the same stream of bursts, kinds and places of edits (drawn
from a stream of its own, ``SHAPE``); the seed draws the contents (tokens,
weights). Two seeds then do the same work on different values: on the
host-bound edit path, seeds that drew their own bursts and kinds differed
by up to a third in edits/s on one H100.
"""
from __future__ import annotations

import numpy as np

OPS = ("replace", "insert", "delete")


SHAPE = 0  # the seed of the shapes every run shares


def rng(seed: int, *stream) -> np.random.Generator:
    """An independent stream of the run's seed (seeds above 2**32 welcome)."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def stratified(lo: int, hi: int, count: int) -> np.ndarray:
    """``count`` lengths log-uniform over [lo, hi]: the midpoints of equal
    slices of log-length, in a shuffled order that every run shares."""
    q = (np.arange(count) + 0.5) / count
    lengths = np.rint(np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo)))).astype(np.int64)
    return rng(SHAPE, 1).permutation(lengths)


def documents(spec: dict, vocab: int, seed: int) -> list:
    """The mix's documents: token arrays of stratified lengths, the tokens
    drawn from the seed."""
    lengths = stratified(spec["len_min"], spec["len_max"], spec["docs"])
    g = rng(seed, 2)
    return [g.integers(0, vocab, int(n), dtype=np.int64).astype(np.int32) for n in lengths]


class Writers:
    """One writer a document, each with a cursor. A round gives every
    writer a burst of ``burst`` [lo, hi] atomic edits (uniform), each within
    ``radius`` tokens of its cursor, of kinds drawn by ``mix``; with
    probability ``p_jump`` the cursor first jumps to a uniform place. The
    writer's document length is tracked so that every edit is valid. The
    bursts, kinds and places come from the shared stream, the inserted and
    replacing tokens from the seed."""

    def __init__(self, spec: dict, lengths: list, vocab: int, seed: int):
        self.spec, self.vocab, self.seed = spec, vocab, seed
        self.lengths = [int(n) for n in lengths]
        g = rng(SHAPE, 3)
        self.cursors = [int(g.integers(0, n)) for n in self.lengths]
        self.p = np.array([spec["mix"][op] for op in OPS], dtype=np.float64)
        self.p /= self.p.sum()
        self.rounds = 0

    def next_round(self) -> list:
        """[(writer, op, pos, token, length before the edit)] of one round,
        writers in order, each writer's edits in the order they are made."""
        s = self.spec
        g, toks = rng(SHAPE, 4, self.rounds), rng(self.seed, 4, self.rounds)
        self.rounds += 1
        out = []
        for w in range(len(self.lengths)):
            n = self.lengths[w]
            if g.random() < s["p_jump"]:
                self.cursors[w] = int(g.integers(0, n))
            for _ in range(int(g.integers(s["burst"][0], s["burst"][1] + 1))):
                op = OPS[int(g.choice(3, p=self.p))]
                if op == "delete" and n <= 1:
                    op = "replace"
                top = n if op == "insert" else n - 1
                pos = int(np.clip(self.cursors[w] + g.integers(-s["radius"], s["radius"] + 1),
                                  0, top))
                tok = int(toks.integers(0, self.vocab))
                out.append((w, op, pos, tok, n))
                n += {"replace": 0, "insert": 1, "delete": -1}[op]
                self.cursors[w] = min(pos + (op == "insert"), max(n - 1, 0))
            self.lengths[w] = n
        return out


def prefill_batches(spec: dict, count: int) -> list:
    """``count`` batch lengths: the mix's ``lengths`` in their order, over
    and over, the same for every seed (the seed draws the tokens), so that
    every run's window holds the same shapes."""
    lengths = [int(n) for n in spec["lengths"]]
    return [lengths[i % len(lengths)] for i in range(count)]
