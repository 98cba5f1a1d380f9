from repro_torch.kernels.vq_assign.ops import (  # noqa: F401
    LAUNCHES, reset_launches, vq_assign, vq_assign_batched,
)
from repro_torch.kernels.vq_assign.ref import codebook_bias, vq_assign_ref  # noqa: F401
