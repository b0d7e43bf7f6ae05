"""The median, nearest rank, over every request of the window of the time
from when it was due to be sent until its answer arrived (host clock of
the load generator), in milliseconds; a request that failed counts as
never answered."""
import math


def read(run: dict):
    recs = [r for c in run["calls"] for r in c.get("records", [])]
    if not recs:
        return None
    lat = sorted((r["done"] - r["due"]) * 1e3 if r.get("status") == 200
                 else math.inf for r in recs)
    return lat[min(len(lat) - 1, math.ceil(0.5 * len(lat)) - 1)]
