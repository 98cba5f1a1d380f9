"""Arithmetic-operation accounting (paper Tables 2, Figs. 3-4).

Copy of ``repro/core/opcount.py`` (pure Python), with its counting
conventions unchanged. The paper's headline numbers are *theoretical
arithmetic operations* for the forward pass, assuming the previous revision
is cached. We count multiply-accumulates as 2 ops (one mul + one add) and
element-wise ops as 1, consistently for the dense baseline and the
incremental path, so the ratios are implementation-independent.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class OpCounter:
    counts: dict = field(default_factory=lambda: defaultdict(int))

    def add(self, name: str, ops) -> None:
        self.counts[name] += int(ops)

    def matmul(self, name: str, m, k, n) -> None:
        """[m,k] @ [k,n] -> 2*m*k*n ops."""
        self.add(name, 2 * int(m) * int(k) * int(n))

    def elementwise(self, name: str, numel, ops_per_element=1) -> None:
        self.add(name, int(numel) * int(ops_per_element))

    @property
    def total(self) -> int:
        return sum(self.counts.values())

    def merge(self, other: "OpCounter") -> None:
        for k, v in other.counts.items():
            self.counts[k] += v

    def summary(self) -> dict:
        out = dict(sorted(self.counts.items()))
        out["TOTAL"] = self.total
        return out


def dense_transformer_forward_ops(
    *,
    n_layers: int,
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    d_ff: int,
    vocab: int,
    seq_len: int,
    ffn_gated: bool = False,
    include_lm_head: bool = True,
) -> int:
    """Analytic op count for one full dense forward pass over ``seq_len``
    tokens (the paper's baseline: re-running OPT from scratch per revision).
    """
    n = seq_len
    d = d_model
    dh = d // n_heads
    ops = 0
    per_layer = 0
    # QKV + output projections.
    per_layer += 2 * n * d * d  # Q
    per_layer += 2 * 2 * n * d * (n_kv_heads * dh)  # K, V
    per_layer += 2 * n * d * d  # out proj
    # Attention core: QK^T and AV, per head.
    per_layer += 2 * n * n * d  # QK^T over all heads = 2*n*n*dh*h
    per_layer += 2 * n * n * d  # AV
    per_layer += n * n * n_heads  # sigma / softmax-ish elementwise (1 op/entry)
    # FFN.
    ffn_mats = 3 if ffn_gated else 2
    per_layer += 2 * ffn_mats * n * d * d_ff
    per_layer += n * d_ff  # activation
    # Norms + residuals (per-location, ~8 ops/element for LN, 1 for add).
    per_layer += 2 * 8 * n * d + 2 * n * d
    ops += n_layers * per_layer
    if include_lm_head:
        ops += 2 * n * d * vocab
    return ops
