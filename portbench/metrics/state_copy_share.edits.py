"""Stacking and unstacking a dispatch's document states (``gather`` +
``scatter`` self time) as a share of the ``flush`` spans' time in the
traced span, in %."""
from portbench import program_spans


def read(obs: dict):
    return program_spans.flush_share(obs, ("gather", "scatter"))
