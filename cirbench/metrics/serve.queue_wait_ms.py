"""Mean time a request of the window waited in the micro-batcher's queue,
from its enqueue to the start of its wave: the growth of ``stats()``
``queue_wait_s`` over that of ``requests`` (``runtime/serve.py``'s own
counters), in milliseconds."""


def read(run: dict):
    c = run["calls"][0]
    if "queue_wait_s" not in c.get("stats0", {}):
        return None
    requests = c["stats1"]["requests"] - c["stats0"]["requests"]
    if requests <= 0:
        return None
    return 1e3 * (c["stats1"]["queue_wait_s"]
                  - c["stats0"]["queue_wait_s"]) / requests
