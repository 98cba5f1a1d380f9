from repro_torch.kernels.incr_patch.ops import (  # noqa: F401
    LAUNCHES, incr_patch, incr_patch_batched, reset_launches,
)
from repro_torch.kernels.incr_patch.ref import incr_patch_ref  # noqa: F401
