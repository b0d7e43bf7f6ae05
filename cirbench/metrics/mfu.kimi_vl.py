"""``mfu.eval``'s reading in the Kimi-VL cell: the model FLOPs of the
window's calls (``cirbench/counts/kimi_vl.py``) over the window's wall
time, as a share of one H100's dense bf16 peak."""
from cirbench import harness

read = harness.load_module("metrics", "mfu.eval").read
