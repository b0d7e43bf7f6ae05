"""Caption composition rules (an own copy of the JAX package's
``data/captions.py``).

Fashion-IQ triplets carry two human captions; the reference composes them:
- eval (deterministic): "Cap1 and cap2" with strip('.?, ') + capitalize
  (validate.py:130-133),
- train (randomized, p=.25 each): cap1+cap2 / cap2+cap1 / cap1 / cap2
  (utils.py:75-96).
CIRR captions are used verbatim.
"""
from __future__ import annotations

import numpy as np


def _clean(c: str) -> str:
    return c.strip(".?, ")


def compose_fiq_eval(captions: list[list[str]]) -> list[str]:
    """[[cap1, cap2], ...] -> deterministic combined captions."""
    return [f"{_clean(c1).capitalize()} and {_clean(c2)}" for c1, c2 in captions]


def compose_fiq_train(captions: list[list[str]],
                      rng: np.random.Generator) -> list[str]:
    """4-way randomized composition (reference utils.py:75-96)."""
    out = []
    for c1, c2 in captions:
        r = rng.random()
        if r < 0.25:
            out.append(f"{_clean(c1).capitalize()} and {_clean(c2)}")
        elif r < 0.5:
            out.append(f"{_clean(c2).capitalize()} and {_clean(c1)}")
        elif r < 0.75:
            out.append(f"{_clean(c1).capitalize()}")
        else:
            out.append(f"{_clean(c2).capitalize()}")
    return out


def fiq_longest_compositions(captions: list[list[str]]) -> list[str]:
    """Both two-caption orders: the longest strings compose_fiq_train can
    emit, so the text-overflow policy can be applied to a whole train split
    before training starts."""
    out = []
    for c1, c2 in captions:
        out.append(f"{_clean(c1).capitalize()} and {_clean(c2)}")
        out.append(f"{_clean(c2).capitalize()} and {_clean(c1)}")
    return out
