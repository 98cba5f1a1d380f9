"""The engine's slow paths (``overflow``, ``grow`` and ``defrag`` spans with
their children) as a share of the ``flush`` spans' time in the traced span,
in %."""
from portbench import program_spans


def read(obs: dict):
    return program_spans.flush_share(obs, ("overflow", "grow", "defrag"), whole=True)
