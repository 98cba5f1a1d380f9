from repro_torch.kernels.gated_attention.ops import (  # noqa: F401
    LAUNCHES, gated_attention, gated_attention_bh, gated_attention_bwd_bh, reset_launches,
)
from repro_torch.kernels.gated_attention.ref import (  # noqa: F401
    gated_attention_bwd_ref, gated_attention_ref,
)
