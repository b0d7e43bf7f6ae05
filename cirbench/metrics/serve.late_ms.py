"""How late the load generator sent: the 95th percentile, nearest rank, of
send time minus due time over the window's requests, in milliseconds. Near
0 means the offered rate was held."""
import math


def read(run: dict):
    recs = [r for c in run["calls"] for r in c.get("records", [])]
    if not recs:
        return None
    late = sorted((r["sent"] - r["due"]) * 1e3 for r in recs)
    return late[min(len(late) - 1, math.ceil(0.95 * len(late)) - 1)]
