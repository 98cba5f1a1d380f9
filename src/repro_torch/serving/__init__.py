"""The port's serving stack. Names resolve lazily (PEP 562), so importing a
submodule — a fleet worker's entry point above all — does not pull in
``torch`` before it is needed."""
import importlib

_EXPORTS = {
    "BatchedJitEngine": "batch_engine", "stack_states": "batch_engine",
    "unstack_state": "batch_engine",
    "BatchServer": "batch_server", "BatchStats": "batch_server",
    "AsyncBatchServer": "async_server", "AsyncStats": "async_server",
    "SuggestionStream": "async_server", "Ticket": "async_server",
    "JitIncrementalEngine": "jit_engine", "JitState": "jit_engine",
    "KVExport": "jit_engine", "weights_from_params": "jit_engine",
    "PositionHeadroomError": "suggest", "SuggestionEngine": "suggest",
    "SuggestStats": "suggest", "oracle_suggestion": "suggest",
    "DeviceBudgetError": "state_store", "StateStore": "state_store",
    "IncrementalServer": "engine", "ServerStats": "engine",
    "make_serving_mesh": "repro_torch.launch.mesh",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        mod = _EXPORTS[name]
        return getattr(importlib.import_module(
            mod if "." in mod else f"repro_torch.serving.{mod}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
