from repro_torch.serving.batch_engine import (  # noqa: F401
    BatchedJitEngine, stack_states, unstack_state,
)
from repro_torch.serving.batch_server import BatchServer, BatchStats  # noqa: F401
from repro_torch.serving.jit_engine import (  # noqa: F401
    JitIncrementalEngine, JitState, KVExport, weights_from_params,
)
from repro_torch.serving.suggest import (  # noqa: F401
    PositionHeadroomError, SuggestionEngine, SuggestStats, oracle_suggestion,
)
