"""The host blocked on the device at a dispatch's one read (``wait`` self
time) as a share of the ``flush`` spans' time in the traced span, in %."""
from portbench import program_spans


def read(obs: dict):
    return program_spans.flush_share(obs, ("wait",))
