"""Issuing the engine's batched step (``issue`` self time: the host's
launches) as a share of the ``flush`` spans' time in the traced span, in
%."""
from portbench import program_spans


def read(obs: dict):
    return program_spans.flush_share(obs, ("issue",))
