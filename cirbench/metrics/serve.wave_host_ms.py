"""Mean host time of a wave of the window: its wall time less the time its
host thread blocked on the card (the ``serve.*.wait`` spans), from the
growth of the micro-batcher's ``stats()`` ``wave_s`` and ``device_wait_s``
over that of ``waves``, in milliseconds."""


def read(run: dict):
    c = run["calls"][0]
    if "device_wait_s" not in c.get("stats0", {}):
        return None
    s0, s1 = c["stats0"], c["stats1"]
    waves = s1["waves"] - s0["waves"]
    if waves <= 0:
        return None
    host = (s1["wave_s"] - s0["wave_s"]) \
        - (s1["device_wait_s"] - s0["device_wait_s"])
    return 1e3 * host / waves
