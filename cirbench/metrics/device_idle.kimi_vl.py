"""``device_idle.eval``'s reading in the Kimi-VL cell: the share of the
traced call's wall time in which no kernel or copy ran on the device."""
from cirbench import harness

read = harness.load_module("metrics", "device_idle.eval").read
