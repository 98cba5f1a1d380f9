"""The port's sharding context (``distributed/context.py``): logical axes
resolved against a device grid of ``launch/mesh.py``."""
