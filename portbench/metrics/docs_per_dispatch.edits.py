"""Documents a batched edit dispatch serves: ``BatchStats.batched_docs /
batch_steps`` over the window (the scheduler's grouping)."""


def read(obs: dict):
    c = obs.get("counters", {})
    return c["batched_docs"] / c["batch_steps"] if c.get("batch_steps") else None
