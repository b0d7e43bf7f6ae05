"""The least time the traced call's routed-expert products need (each
grouped pass's operations at 989 TFLOP/s or its bytes at 3.35 TB/s,
whichever is larger: the experts' weights read once a pass, each routed
row read and written once; ``cirbench/counts/kimi_vl.py``) over the
device time of the kernels that run them: ``torch._grouped_mm``'s CUTLASS
grouped GEMM, whose name holds its ``GroupProblemShape``."""


def read(run: dict):
    names = run["trace"].get("kernels_us") or {}
    us = sum(t for name, t in names.items() if "GroupProblemShape" in name)
    work = run["work"]
    if not us or "moe_least_s" not in work:
        return None
    return 100.0 * work["moe_least_s"] / (us / 1e6)
