"""The share of the window's wall time in which the micro-batcher's worker
was blocked on an empty queue: the growth of its ``stats()`` ``idle_s``
over the window's ``wall``."""


def read(run: dict):
    c = run["calls"][0]
    if "idle_s" not in c.get("stats0", {}) or c["wall"] <= 0:
        return None
    return 100.0 * (c["stats1"]["idle_s"] - c["stats0"]["idle_s"]) \
        / c["wall"]
