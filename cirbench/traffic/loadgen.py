"""An open-loop HTTP load generator, run in a child process of its own so
that it never contends for the server's interpreter lock.

Each request is sent at its due time (seconds from the start) from a
thread of its own, whatever the server's backlog, and timed from that due
time until its answer arrived. Standard library only."""
from __future__ import annotations

import http.client
import json
import threading
import time


def _send(port: int, body: bytes, timeout: float) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/rank", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def drive(port: int, due: list[float], bodies: list[dict],
          timeout: float = 120.0) -> list[dict]:
    """Send ``bodies[i]`` at ``due[i]`` seconds after the start; returns one
    record a request: due, sent and done (seconds from the start), the
    HTTP status and the answer (or the error)."""
    out: list[dict] = [{} for _ in due]
    t0 = time.perf_counter()

    def one(i: int, sent: float):
        try:
            status, data = _send(port, json.dumps(bodies[i]).encode(),
                                 timeout)
            answer = json.loads(data)
        except (OSError, http.client.HTTPException, ValueError) as e:
            status, answer = 0, {"error": repr(e)}
        out[i] = {"due": due[i], "sent": sent,
                  "done": time.perf_counter() - t0, "status": status,
                  "answer": answer}

    threads = []
    for i, d in enumerate(due):
        wait = d - (time.perf_counter() - t0)
        if wait > 0:
            time.sleep(wait)
        th = threading.Thread(target=one,
                              args=(i, time.perf_counter() - t0),
                              daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout)
    return out


def child(conn) -> None:
    """Entry point of the child process: takes (due, port, bodies) jobs
    from ``conn``, drives each and sends its records back, until None."""
    while True:
        job = conn.recv()
        if job is None:
            break
        due, port, bodies = job
        conn.send(drive(port, due, bodies))
    conn.close()
