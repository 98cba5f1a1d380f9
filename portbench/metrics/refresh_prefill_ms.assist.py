"""The mean ``prefill`` self ms a suggestion refresh (issuing the
re-prefill's bucketed chunk) over the traced span's refreshes."""
from portbench import program_spans


def read(obs: dict):
    return program_spans.refresh_ms(obs, "prefill")
