"""Requests a wave of the micro-batcher over the window: the growth of its
``stats()['requests']`` over that of ``['waves']`` (``runtime/serve.py``'s
own counters)."""


def read(run: dict):
    c = run["calls"][0]
    if "stats0" not in c:
        return None
    waves = c["stats1"]["waves"] - c["stats0"]["waves"]
    if waves <= 0:
        return None
    return (c["stats1"]["requests"] - c["stats0"]["requests"]) / waves
