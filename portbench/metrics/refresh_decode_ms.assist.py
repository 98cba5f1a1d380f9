"""The mean ``decode`` self ms a suggestion refresh (the greedy decode
steps and the continuation's host read) over the traced span's
refreshes."""
from portbench import program_spans


def read(obs: dict):
    return program_spans.refresh_ms(obs, "decode")
