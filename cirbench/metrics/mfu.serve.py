"""The model FLOPs of the window's answered requests (``cirbench/counts``,
one request of the traffic's mean caption length) over the window's wall
time, as a share of one H100's dense bf16 peak, 989 TFLOP/s."""
from cirbench.counts import kernels


def read(run: dict):
    c = run["calls"][0]
    if run["device"] != "cuda" or "records" not in c:
        return None
    done = sum(r.get("status") == 200 for r in c["records"])
    return 100.0 * done * run["work"]["flops"] / c["wall"] \
        / kernels.PEAK_BF16_FLOPS
