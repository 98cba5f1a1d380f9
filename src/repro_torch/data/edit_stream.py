"""Edit-stream generator — the offline stand-in for the paper's scraped
Wikipedia revision histories (§4).

Copy of ``repro/data/edit_stream.py`` (NumPy only): seeded outputs equal
the reference's.

Produces (base document, revision) pairs with a controlled edit fraction and
bursty (clustered) edit locations, plus atomic-edit streams for the online
experiment.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from repro_torch.core.edits import Edit, edit_script, random_atomic_edit, random_revision
from repro_torch.data.synthetic import SyntheticCorpus


@dataclass
class EditStream:
    corpus: SyntheticCorpus
    doc_len: int = 512
    seed: int = 0

    def base_document(self, i: int) -> np.ndarray:
        return self.corpus.document(self.doc_len, 50_000 + i)

    def atomic_edits(self, doc_id: int, n_edits: int) -> Iterator[Edit]:
        """A stream of single-token edits to one document (online case)."""
        rng = np.random.default_rng((self.seed, doc_id))
        tokens = list(self.base_document(doc_id))
        for _ in range(n_edits):
            e = random_atomic_edit(rng, tokens, self.corpus.vocab)
            yield e
            from repro_torch.core.edits import apply_edit

            tokens = apply_edit(tokens, e)

    def revision(self, doc_id: int, edit_fraction: float) -> tuple[np.ndarray, np.ndarray]:
        """(old, new) revision pair with ~edit_fraction of tokens modified."""
        rng = np.random.default_rng((self.seed, 1, doc_id))
        old = self.base_document(doc_id)
        new = np.asarray(random_revision(rng, old, self.corpus.vocab, edit_fraction))
        return old, new


@dataclass
class TrafficGenerator:
    """Seeded serving traffic for the load benchmarks (async_load, fleet_load).

    Models what a fleet of editor sessions actually does to a serving tier:

    * **zipf document popularity** — a few hot documents absorb most
      sessions (that is what makes a hot tier and sticky routing matter);
    * **Poisson-ish session arrival/departure** — sessions open a document,
      edit in bursts, and close with probability ``p_close``, so the open
      document set churns over the run;
    * **typing bursts vs revise bursts** — a typing burst is a run of
      inserts at an advancing cursor (the append-heavy best case); a revise
      burst is replaces/deletes clustered around a point (the bursty
      Wikipedia-style worst case, cf. ``random_revision``).

    Everything is derived from ``seed`` so concurrent clients and their
    sequential oracles replay identical streams. Ops are emitted against an
    evolving per-document reference, so each (kind, pos, tok) is valid at
    its application time.
    """

    vocab: int
    n_docs: int = 8
    doc_len: int = 32
    seed: int = 0
    zipf_a: float = 1.3
    p_typing: float = 0.6

    def __post_init__(self):
        ranks = np.arange(1, self.n_docs + 1, dtype=np.float64)
        w = ranks ** -self.zipf_a
        self.popularity = w / w.sum()

    def base_document(self, doc_idx: int) -> list[int]:
        rng = np.random.default_rng((self.seed, 11, doc_idx))
        return [int(t) for t in rng.integers(0, self.vocab, self.doc_len)]

    def burst_ops(self, rng: np.random.Generator, ref: list,
                  n_edits: int) -> list[tuple]:
        """One burst of exactly ``n_edits`` ops against (and mutating)
        ``ref``; each op is ``(kind, pos, tok)``."""
        ops: list[tuple] = []
        if rng.random() < self.p_typing:  # typing: inserts at a cursor
            cur = int(rng.integers(len(ref) + 1))
            for _ in range(n_edits):
                tok = int(rng.integers(self.vocab))
                ref.insert(cur, tok)
                ops.append(("insert", cur, tok))
                cur += 1
            return ops
        center = int(rng.integers(len(ref)))  # revise: clustered churn
        for _ in range(n_edits):
            kind = str(rng.choice(["replace", "delete", "insert"],
                                  p=[0.6, 0.2, 0.2]))
            if kind == "delete" and len(ref) <= 6:
                kind = "replace"
            pos = min(max(center + int(rng.integers(-3, 4)), 0),
                      len(ref) - (0 if kind == "insert" else 1))
            tok = int(rng.integers(self.vocab))
            if kind == "insert":
                ref.insert(pos, tok)
            elif kind == "delete":
                del ref[pos]
            else:
                ref[pos] = tok
            ops.append((kind, pos, tok))
            center = min(pos, max(len(ref) - 1, 0))
        return ops

    def session_ops(self, doc_idx: int, n_edits: int,
                    ref: list) -> list[tuple]:
        """A single session's seeded op stream for one document: exactly
        ``n_edits`` ops in alternating typing/revise bursts, mutating
        ``ref`` as they go (the async_load per-client stream)."""
        rng = np.random.default_rng((self.seed, 23, doc_idx))
        ops: list[tuple] = []
        while len(ops) < n_edits:
            burst = 1 + int(rng.poisson(2.0))
            ops.extend(self.burst_ops(rng, ref,
                                      min(burst, n_edits - len(ops))))
        return ops

    def fleet_events(self, n_sessions: int, mean_burst: float = 3.0,
                     bursts_per_session: int = 2, n_new: int = 4,
                     p_close: float = 0.35) -> tuple[list[tuple], dict]:
        """An interleaved fleet-wide event schedule.

        Returns ``(events, final_refs)``: events are, in order,
        ``("open", doc, tokens)`` / ``("edit", doc, (kind, pos, tok))`` /
        ``("suggest", doc, n_new)`` / ``("close", doc)``; ``final_refs``
        maps every document ever touched to its token list after the last
        event (documents closed by a departure re-open with their retained
        tokens on the next session, like a real editor reconnecting).
        """
        rng = np.random.default_rng((self.seed, 37))
        events: list[tuple] = []
        refs: dict[str, list] = {}
        is_open: dict[str, bool] = {}
        for _ in range(n_sessions):
            idx = int(rng.choice(self.n_docs, p=self.popularity))
            doc = f"doc{idx}"
            if doc not in refs:
                refs[doc] = self.base_document(idx)
            if not is_open.get(doc, False):
                events.append(("open", doc, list(refs[doc])))
                is_open[doc] = True
            for _ in range(bursts_per_session):
                n = 1 + int(rng.poisson(max(mean_burst - 1.0, 0.0)))
                for op in self.burst_ops(rng, refs[doc], n):
                    events.append(("edit", doc, op))
                events.append(("suggest", doc, n_new))
            if rng.random() < p_close:  # Poisson-ish departure
                events.append(("close", doc))
                is_open[doc] = False
        return events, refs


def revision_pairs(
    stream: EditStream, n_pairs: int, fractions=(0.002, 0.005, 0.01, 0.02, 0.05, 0.1)
) -> Iterator[tuple[np.ndarray, np.ndarray, list[Edit], float]]:
    """Yields (old, new, edit_script, fraction) like the paper's scraped
    Wikipedia pairs — fraction is drawn log-uniformly from ``fractions``."""
    rng = np.random.default_rng(stream.seed + 99)
    for i in range(n_pairs):
        frac = float(fractions[rng.integers(len(fractions))])
        old, new = stream.revision(i, frac)
        yield old, new, edit_script(old, new), frac
