from repro_torch.kernels.gated_attention.ops import (  # noqa: F401
    LAUNCHES, gated_attention, gated_attention_bh, reset_launches,
)
from repro_torch.kernels.gated_attention.ref import gated_attention_ref  # noqa: F401
