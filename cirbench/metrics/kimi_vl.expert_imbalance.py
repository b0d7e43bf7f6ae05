"""The routed experts' load imbalance over the window's calls: the busiest
expert's rows, summed over every routed layer pass, over the mean expert's
(rows routed / experts), from the program's counter ``registry.MOE``; 1 is
an even spread, and the grouped products wait on the busiest group."""


def read(run: dict):
    moe = [c["moe"] for c in run["calls"] if c.get("moe", {}).get("routed")]
    if not moe:
        return None
    busiest = sum(m["busiest"] for m in moe)
    mean = sum(m["routed"] / m["experts"] for m in moe)
    return busiest / mean
