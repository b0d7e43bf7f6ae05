"""The share of the traced BLIP-2 evaluation call's wall time in which no
kernel or copy ran on the device."""


def read(run: dict):
    tr = run["trace"]
    if not tr.get("window_us"):
        return None
    return 100.0 * (1.0 - tr["busy_us"] / tr["window_us"])
