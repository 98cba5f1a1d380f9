"""Share of the suggestion re-prefills' rows served from cached state:
``SuggestStats`` rows reused / (reused + recomputed) over the window, in %."""


def read(obs: dict):
    c = obs.get("counters", {})
    total = c.get("rows_reused", 0) + c.get("rows_recomputed", 0)
    return 100.0 * c["rows_reused"] / total if total else None
