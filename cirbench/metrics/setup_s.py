"""Seconds from the process's start until the window opens: imports, the
card's context, weights and traffic from the seed, the models' set-up and
the warm-up (host clock)."""


def read(run: dict):
    return run["setup_s"]
