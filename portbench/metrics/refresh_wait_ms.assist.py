"""The median wait of a suggestion refresh behind its round: from the start
of the ``flush`` span that holds a ``refresh`` span to the refresh's start,
in ms, over the traced span's refreshes."""
from portbench import program_spans


def read(obs: dict):
    return program_spans.refresh_wait_ms(obs)
