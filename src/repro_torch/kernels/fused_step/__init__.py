from repro_torch.kernels.fused_step.ops import (  # noqa: F401
    LAUNCHES, delta_gate, fused_patch_assign, fused_patch_assign_batched,
    reset_launches,
)
from repro_torch.kernels.fused_step.ref import (  # noqa: F401
    delta_gate_ref, fused_patch_assign_ref,
)
