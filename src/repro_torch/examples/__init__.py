"""Runnable demos of the port, the counterparts of the repository's
``examples/`` scripts: ``python -m repro_torch.examples.quickstart`` and
``python -m repro_torch.examples.incremental_serving`` (``--device cpu``
runs the plain PyTorch path)."""
