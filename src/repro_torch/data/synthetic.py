"""Synthetic language-model corpus (offline stand-in for the Pile, paper §4).

Copy of ``repro/data/synthetic.py`` (NumPy only): seeded outputs equal the
reference's. A second-order Markov chain over a Zipfian vocabulary with topic blocks:
documents carry enough local structure (bigram dependencies, repeated topical
words) that a small transformer measurably learns it, while generation stays
fast and deterministic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class SyntheticCorpus:
    vocab: int
    seed: int = 0
    n_topics: int = 16
    topic_words: int = 64

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # Zipfian unigram distribution
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        # per-topic boosted word sets
        self.topics = rng.integers(0, self.vocab, size=(self.n_topics, self.topic_words))
        # bigram successor table: each token has a handful of likely successors
        self.succ = rng.integers(0, self.vocab, size=(self.vocab, 4))

    def document(self, length: int, seed: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, seed))
        topic = rng.integers(self.n_topics)
        words = self.topics[topic]
        out = np.empty(length, np.int64)
        prev = int(rng.choice(words))
        for i in range(length):
            r = rng.random()
            if r < 0.45:  # follow bigram structure
                prev = int(self.succ[prev, rng.integers(4)])
            elif r < 0.8:  # topical word
                prev = int(words[rng.integers(self.topic_words)])
            else:  # Zipf background
                prev = int(rng.choice(self.vocab, p=self.unigram))
            out[i] = prev
        return out

    def classification_doc(self, length: int, seed: int) -> tuple[np.ndarray, int]:
        """Binary 'sentiment' task: label = which of two topic groups dominates
        (IMDB stand-in for the accuracy-parity experiment)."""
        rng = np.random.default_rng((self.seed, 7, seed))
        label = int(rng.integers(2))
        # two disjoint "sentiment lexicons" in the token space
        group = np.arange(64) + (100 if label == 0 else 200)
        doc = self.document(length, seed + 10_000)
        # plant label-revealing words densely enough for few-step fine-tunes
        n_plant = max(4, length // 6)
        idx = rng.choice(length, n_plant, replace=False)
        doc[idx] = group[rng.integers(0, len(group), n_plant)]
        return doc, label


def lm_batches(
    corpus: SyntheticCorpus,
    *,
    batch: int,
    seq_len: int,
    steps: int,
    seed: int = 0,
    pos_pool: Optional[int] = None,
) -> Iterator[dict]:
    """Yields {tokens [b, n], positions? [b, n]} batches. When ``pos_pool`` is
    set, positions are sampled ordered subsets (paper §3.3 training scheme)."""
    rng = np.random.default_rng(seed)
    for s in range(steps):
        toks = np.stack(
            [corpus.document(seq_len, seed * 100_000 + s * batch + i) for i in range(batch)]
        )
        out = {"tokens": toks}
        if pos_pool:
            pos = np.sort(
                np.stack(
                    [rng.choice(pos_pool, seq_len, replace=False) for _ in range(batch)]
                ),
                axis=-1,
            ).astype(np.int32)
            out["positions"] = pos
        yield out
