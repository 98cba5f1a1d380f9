"""The device's idle share in the traced span: 1 − busy / wall, in %
(busy: the sum of every device operation's self time)."""


def read(obs: dict):
    t = obs.get("trace")
    if not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
