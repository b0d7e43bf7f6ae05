"""Queries evaluated a second: every query of the window's whole
evaluation calls over those calls' wall time (host clock, each call
ending in a device sync)."""


def read(run: dict):
    calls = run["calls"]
    if not calls:
        return None
    return sum(c["queries"] for c in calls) / sum(c["wall"] for c in calls)
