"""Multi-replica fleet serving: N replica workers — each a subprocess owning
one ``AsyncBatchServer`` — behind a ``FleetRouter`` that places documents by
load, keeps routing sticky, migrates documents across replicas through the
shared cold tier, and fails dead replicas' documents over to survivors.

Names resolve lazily, so the worker's entry point
(``python -m repro_torch.serving.fleet.worker``) claims its RPC pipe before
``torch`` loads."""
import importlib

__all__ = ["FleetRouter", "RemoteOpError", "ReplicaDiedError"]


def __getattr__(name):
    if name in __all__:
        return getattr(importlib.import_module(
            "repro_torch.serving.fleet.router"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
