"""Share of batched edit dispatches that overflowed their row bucket and
fell back to a full forward: ``BatchStats.overflows / batch_steps`` over
the window, in %."""


def read(obs: dict):
    c = obs.get("counters", {})
    return 100.0 * c["overflows"] / c["batch_steps"] if c.get("batch_steps") else None
