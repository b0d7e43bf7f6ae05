"""Mean wall time of a wave of the window (the engine's ``handle``): the
growth of the micro-batcher's ``stats()`` ``wave_s`` over that of
``waves``, in milliseconds."""


def read(run: dict):
    c = run["calls"][0]
    if "wave_s" not in c.get("stats0", {}):
        return None
    waves = c["stats1"]["waves"] - c["stats0"]["waves"]
    if waves <= 0:
        return None
    return 1e3 * (c["stats1"]["wave_s"] - c["stats0"]["wave_s"]) / waves
