"""Runnable demos of the port, the counterparts of the repository's
``examples/`` scripts: ``python -m repro_torch.examples.quickstart``,
``python -m repro_torch.examples.incremental_serving`` and
``python -m repro_torch.examples.multiarch_decode`` (``--device cpu`` runs
the plain PyTorch path)."""
