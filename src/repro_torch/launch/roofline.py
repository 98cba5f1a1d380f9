"""Analytic roofline of the incremental edit step — ``repro/launch/roofline.py``
on the port.

This module prices what the incremental algorithm *must* do for one
``(B, n_cap, C, R)`` bucketed step — the useful work — so a measurement can
set a dispatch's device time beside its floor. It counts only the
matmul-shaped terms (projections, score dots, value accumulations);
elementwise work (gelu, masks, argmax) is O(of the same shapes) and under
the constant-factor noise floor of a roofline.

The functions are pure shape arithmetic, the reference's own, and equal to
its numbers for the same arguments. The module's default peaks are the
H100's (SXM, NVIDIA data sheet): 67 TFLOP/s of FP32 outside the tensor
cores, on which the port's edit step runs its products, and 3.35 TB/s of
HBM. ``RooflineReport`` takes other peaks as fields.

``xla_flops`` / ``xla_bytes`` keep the reference's names, where XLA's
``cost_analysis()`` of the compiled step fills them. The port has no
compiled step: ``chip_smoke.py`` fills ``xla_flops`` with
``torch.utils.flop_counter.FlopCounterMode``'s count of one eager dispatch
(the aten products it sees; the hand-written kernels' products, called
through ctypes, are not among them) and passes 0 bytes.
"""
from __future__ import annotations

from dataclasses import dataclass

PEAK_FLOPS = 67e12  # H100 SXM, FP32 FMA outside the tensor cores
HBM_BW = 3.35e12  # H100 SXM, bytes/s


def edit_step_flops(n_layers: int, meta: dict, n_cap: int, C: int,
                    R: int, d_ff: int = 0) -> float:
    """Useful FLOPs of ONE document's bucketed ``apply_edits`` step.

    Per layer the incremental algorithm (paper §3.2, DESIGN.md §3) does:

    * edited-slot refresh: C slots re-embed and re-project to q/k/v
      (2·C·d·3·H·dh) and re-code through the VQ value path (2·C·H·dh·Q);
    * column patch: every row's totals gain the new-minus-old contribution
      of the C patched columns — scores (2 dots) 2·2·n·C·H·dh and value
      accumulations 2·2·n·C·H·Q;
    * dirty-row recompute: R rows re-run full attention over n columns —
      scores 2·R·n·H·dh, accumulation 2·R·n·H·Q — then the row MLP
      (2·R·d·d_ff·2; ``d_ff`` defaults to 4·d when not given) and output
      projection (2·R·H·dh·d).

    ``n_cap`` stands in for ``n`` (the step cannot see n_real): a half-full
    capacity class doubles the floor relative to its truly useful work.
    """
    d, H, dh, Q = meta["d"], meta["H"], meta["dh"], meta["Q"]
    d_ff = d_ff or 4 * d
    n = n_cap
    per_layer = (
        2 * C * d * 3 * H * dh        # edited-slot qkv projection
        + 2 * C * H * dh * Q          # edited-slot VQ value coding
        + 2 * 2 * n * C * H * dh      # patch scores (old + new columns)
        + 2 * 2 * n * C * H * Q       # patch value accumulation (old + new)
        + 2 * R * n * H * dh          # dirty-row scores
        + 2 * R * n * H * Q           # dirty-row value accumulation
        + 2 * R * d * d_ff * 2        # dirty-row MLP (in + out mats)
        + 2 * R * H * dh * d          # dirty-row output projection
    )
    return float(n_layers) * per_layer


def edit_step_bytes(n_layers: int, meta: dict, n_cap: int,
                    weight_bytes: int = 0) -> float:
    """Minimum HBM traffic of one step: read + write the document state
    (every leaf is gathered/scattered at least once by the patch) plus one
    read of the weight stacks (``weight_bytes``; pass the engine's real
    number, 0 to price state traffic alone)."""
    from repro_torch.serving.jit_engine import state_nbytes_for

    return 2.0 * state_nbytes_for(n_cap, n_layers, meta) + float(weight_bytes)


@dataclass
class RooflineReport:
    """Analytic floor against the counted cost of one step."""
    analytic_flops: float
    analytic_bytes: float
    xla_flops: float
    xla_bytes: float
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW

    @property
    def compute_s(self) -> float:
        return self.analytic_flops / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.analytic_bytes / self.hbm_bw

    @property
    def bottleneck(self) -> str:
        return "compute" if self.compute_s >= self.memory_s else "memory"

    @property
    def useful_flop_fraction(self) -> float:
        """analytic / counted FLOPs: how much of the step is algorithmically
        necessary (1.0 = no waste; small = the step spends its arithmetic on
        padding or redundant recompute)."""
        return self.analytic_flops / self.xla_flops if self.xla_flops else 0.0

    @property
    def useful_byte_fraction(self) -> float:
        return self.analytic_bytes / self.xla_bytes if self.xla_bytes else 0.0

    def summary(self) -> dict:
        return {
            "analytic_flops": self.analytic_flops,
            "analytic_bytes": self.analytic_bytes,
            "xla_flops": self.xla_flops,
            "xla_bytes": self.xla_bytes,
            "useful_flop_fraction": round(self.useful_flop_fraction, 6),
            "useful_byte_fraction": round(self.useful_byte_fraction, 6),
            "bottleneck": self.bottleneck,
        }


def edit_step_roofline(n_layers: int, meta: dict, n_cap: int, C: int, R: int,
                       *, xla_flops: float, xla_bytes: float,
                       weight_bytes: int = 0, batch: int = 1,
                       d_ff: int = 0) -> RooflineReport:
    """Price a ``(B, n_cap, C, R)`` batched edit step against its analytic
    floor. ``xla_flops``/``xla_bytes`` are the counted whole-batch numbers;
    the analytic side scales the per-document model by ``batch`` and
    charges the weights once (they are shared across the batch)."""
    return RooflineReport(
        analytic_flops=batch * edit_step_flops(n_layers, meta, n_cap, C, R,
                                               d_ff=d_ff),
        analytic_bytes=(batch * edit_step_bytes(n_layers, meta, n_cap)
                        + float(weight_bytes)),
        xla_flops=float(xla_flops), xla_bytes=float(xla_bytes),
    )
