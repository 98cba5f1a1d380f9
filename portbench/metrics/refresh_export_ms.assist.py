"""The mean ``export`` self ms a suggestion refresh (the host order of the
document's rows and the KV export) over the traced span's refreshes."""
from portbench import program_spans


def read(obs: dict):
    return program_spans.refresh_ms(obs, "export")
