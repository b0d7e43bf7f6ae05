"""The model FLOPs of the window's BLIP-2 evaluation calls
(``cirbench/counts/blip2.py``) over the window's wall time, as a share of
one H100's dense bf16 peak, 989 TFLOP/s (the card's power limit is
printed beside every run)."""
from cirbench.counts import kernels


def read(run: dict):
    calls = run["calls"]
    if not calls or run["device"] != "cuda":
        return None
    wall = sum(c["wall"] for c in calls)
    return 100.0 * len(calls) * run["work"]["flops"] / wall \
        / kernels.PEAK_BF16_FLOPS
