"""The yardstick's arithmetic: the H100's peaks, and the operations and
bytes each kernel and each step needs, from the shapes of its inputs.

Frozen copies: ``edit_step_flops`` of ``repro_torch/launch/roofline.py``,
and ``bound``, ``attention_work``, ``attention_bwd_work``, the
``fused_step`` and ``vq_assign`` work of ``chip_smoke.py``
(``tests/test_portbench_frozen.py`` holds them equal to those at the
served shapes). What changed is the peak: every share here counts the
algorithm's float32 operations once against the dense TF32 tensor-core
rate, the fastest way this card has to a float32-accurate product (3×TF32
reaches about a third of it), so a share cannot pass 100% unless work was
skipped. A share is reported with the card's power limit beside it.
"""
from __future__ import annotations

PEAK_FLOPS = 495e12  # H100 SXM, dense TF32 on the tensor cores (data sheet)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM


def bound_s(nbytes: float, flops: float) -> float:
    """Least seconds the card could take: bytes over the memory rate or
    operations over the peak, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS)


def edit_step_flops(n_layers: int, meta: dict, n_cap: int, C: int,
                    R: int, d_ff: int = 0) -> float:
    """Useful FLOPs of one document's edit step of C edited slots and R
    recomputed rows over n (``n_cap``) columns: the edited slots' q/k/v
    projection and VQ value coding, the column patch of every row's scores
    and value sums, the dirty rows' attention, MLP and output projection."""
    d, H, dh, Q = meta["d"], meta["H"], meta["dh"], meta["Q"]
    d_ff = d_ff or 4 * d
    n = n_cap
    per_layer = (
        2 * C * d * 3 * H * dh
        + 2 * C * H * dh * Q
        + 2 * 2 * n * C * H * dh
        + 2 * 2 * n * C * H * Q
        + 2 * R * n * H * dh
        + 2 * R * n * H * Q
        + 2 * R * d * d_ff * 2
        + 2 * R * H * dh * d
    )
    return float(n_layers) * per_layer


def causal_pairs(nq: int, nk: int) -> int:
    """Σ_{i < nq} min(i + 1, nk): the (query, key) pairs of causal attention
    whose row i sees keys 0..i."""
    m = min(nq, nk)
    return m * (m + 1) // 2 + (nq - m) * nk


def attention_work(BH: int, nq: int, nk: int, dh: int = 64) -> tuple[int, int]:
    """(bytes, FP32 operations) of causal σ attention: q, k, v read and O
    written once; 2 operations a multiply-add of q kᵀ and W v."""
    return 4 * 2 * BH * (nq + nk) * dh, BH * causal_pairs(nq, nk) * 4 * dh


def attention_bwd_work(BH: int, n: int, dh: int = 64) -> tuple[int, int]:
    """(bytes, operations) of the σ attention backward at nq = nk = n: q, k,
    v, dO read and dq, dk, dv written once; the five products the gradient
    needs (S, dW, dV, dK, dQ), 2·dh operations each a causal pair."""
    pairs = n * (n + 1) // 2
    return 7 * BH * n * dh * 4, BH * pairs * 5 * 2 * dh


def fused_step_work(B: int, n: int, C: int, H: int, dh: int, Q: int, hq: int,
                    live: float) -> tuple[float, float]:
    """(bytes, operations) of one ``fused_step`` launch: every input (q,
    k_new, k_old, vc_new, vc_old, mask, T_base, counts, vq_bias) read once,
    T and the codes written once; two scores and two value sums a live
    (row, column, head), the head sums, the scaling and the code choice."""
    numel = (B * n * H * dh + 2 * B * H * C * dh + 2 * B * H * C * Q + B * n * C
             + B * n * H * Q + B * n + hq * Q)
    nbytes = 4 * (numel + B * n * H * Q + B * n * hq)
    flops = live * H * (4 * dh + 4 * Q) + 2 * B * n * H * Q + 2 * B * n * hq * Q
    return nbytes, flops


def vq_assign_work(M: int, hq: int, Q: int, dv: int) -> tuple[int, int]:
    """(bytes, operations) of nearest-code assignment of M rows of hq
    slices: x read and x_q written, the codebook read, the codes written;
    one dot product a (row, head, code)."""
    return 4 * (2 * M * hq * dv + hq * Q * dv + M * hq), 2 * M * hq * Q * dv


def dense_matmul_params(cfg: dict) -> int:
    """Weights a token multiplies in one layer: q, k, v, o and the MLP."""
    d, H, Hkv = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    dh = cfg.get("head_dim") or d // H
    mlp = 3 if cfg["ffn"] == "swiglu" else 2
    return d * H * dh * 2 + d * Hkv * dh * 2 + mlp * d * cfg["d_ff"]


def forward_flops(cfg: dict, tokens: int, attended: int, head_rows: int) -> float:
    """Forward FLOPs of ``tokens`` tokens of which ``attended`` (query, key)
    pairs are causal ones, with the output projection over the vocabulary
    on ``head_rows`` rows: the layers' matmuls, σ attention (q kᵀ and
    W v), the VQ code scores, and the head."""
    d, H = cfg["d_model"], cfg["n_heads"]
    dh = cfg.get("head_dim") or d // H
    vq = cfg["vqt"]
    per_token = 2 * dense_matmul_params(cfg) + 2 * vq["codebook_size"] * H * dh
    return (cfg["n_layers"] * (tokens * per_token + attended * 4 * H * dh)
            + head_rows * 2 * d * cfg["vocab"])
