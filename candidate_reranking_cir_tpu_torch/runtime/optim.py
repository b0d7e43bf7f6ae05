"""Optimizer and LR schedules (port of the JAX package's
``runtime/optim.py``).

AdamW(b1 0.9, b2 0.999, eps 1e-8, weight decay) over the trainable
parameters with optax's semantics:
- the LR of update n is ``schedule(n)``, counted before the increment;
- weight decay is decoupled (p -= lr * (adam + wd * p)) and applies to
  every trainable parameter, a zero gradient included;
- frozen prefixes (e.g. ``visual_encoder``) get ``requires_grad=False``,
  no optimizer state and no update, so they stay bit-identical;
- gradient accumulation over k micro-steps averages them with
  ``optax.MultiSteps``' running mean, acc += (g - acc) / (i + 1), and
  updates on the k-th.
The update repeats optax's float32 arithmetic op for op, including its
bias corrections 1 - b**count taken in float32 (``torch.optim.AdamW``
takes them in float64, which moves an early update by about 6e-6 of its
size).
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
from torch import nn

from candidate_reranking_cir_tpu_torch.config import TrainConfig


def cosine_epoch_schedule(init_lr: float, min_lr: float, max_epoch: int,
                          steps_per_epoch: int) -> Callable[[int], float]:
    """Epoch-granular cosine decay (reference utils.py:216-221): constant
    within an epoch, stepping down between epochs."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return (init_lr - min_lr) * 0.5 * (
            1.0 + math.cos(math.pi * epoch / max_epoch)) + min_lr

    return schedule


def warmup_schedule(init_lr: float, max_lr: float,
                    max_step: int) -> Callable[[int], float]:
    """Linear warmup (reference utils.py:223-228)."""

    def schedule(step: int) -> float:
        return min(max_lr, init_lr + (max_lr - init_lr) * step / max_step)

    return schedule


def step_epoch_schedule(init_lr: float, min_lr: float, decay_rate: float,
                        steps_per_epoch: int) -> Callable[[int], float]:
    """Stepwise exponential decay per epoch (reference utils.py:230-235)."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return max(min_lr, init_lr * decay_rate ** epoch)

    return schedule


def exp_epoch_schedule(init_lr: float, gamma: float,
                       steps_per_epoch: int) -> Callable[[int], float]:
    """Multiplicative per-epoch decay (reference utils.py:237-241)."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return init_lr * gamma ** epoch

    return schedule


def is_frozen(name: str, freeze_prefixes: tuple[str, ...]) -> bool:
    """Whether parameter ``name`` lies under one of the module prefixes
    (e.g. 'visual_encoder')."""
    return any(name == p or name.startswith(p + ".") for p in freeze_prefixes)


def _f32(x: float) -> float:
    return float(np.float32(x))


class AdamW:
    """AdamW (optax.adamw) with a step-indexed LR schedule and gradient
    accumulation, over float32 parameters.

    ``step()`` after each micro-step's backward; it returns True when the
    parameters were updated. ``zero_grad()`` before the next backward.
    ``state_dict()`` / ``load_state_dict()`` carry the counters and the
    moments (and, under accumulation, the running mean of the cycle in
    progress): the port's counterpart of the ``opt_state`` the JAX
    package saves through ``optax.MultiSteps``."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params, schedule: Callable[[int], float],
                 weight_decay: float, accumulation: int = 1):
        if accumulation < 1:
            raise ValueError("accumulation must be >= 1")
        self.params = list(params)
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.accumulation = accumulation
        self.count = 0        # updates applied (the schedule's step)
        self.mini_step = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if accumulation > 1 else None)

    @property
    def micro_steps(self) -> int:
        """Micro-steps taken (the JAX train state's ``step``)."""
        return self.count * self.accumulation + self.mini_step

    def state_dict(self) -> dict:
        return {"count": self.count, "mini_step": self.mini_step,
                "accumulation": self.accumulation, "mu": list(self.mu),
                "nu": list(self.nu),
                "acc": None if self.acc is None else list(self.acc)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a ``state_dict()`` into this optimizer's tensors (on their
        devices). Its parameters must have the saved shapes, in order, and
        the accumulation must be the saved one."""
        if state["accumulation"] != self.accumulation:
            raise ValueError(
                f"the state accumulates over {state['accumulation']} "
                f"micro-steps, this optimizer over {self.accumulation}")
        for key in ("mu", "nu") + (("acc",) if self.acc is not None else ()):
            mine, saved = getattr(self, key), state[key]
            if len(saved) != len(mine) or any(
                    a.shape != b.shape for a, b in zip(mine, saved)):
                raise ValueError(
                    f"optimizer state {key!r} does not fit the trainable "
                    f"parameters ({len(saved)} tensors saved, {len(mine)} "
                    "here)")
            for a, b in zip(mine, saved):
                a.copy_(b)
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> bool:
        for p in self.params:
            if p.grad is None:  # optax decays a zero gradient too
                p.grad = torch.zeros_like(p)
        if self.acc is not None:
            n = self.mini_step
            for p, acc in zip(self.params, self.acc):
                acc.add_((p.grad - acc) / (n + 1))
            self.mini_step += 1
            if self.mini_step < self.accumulation:
                return False
            self.mini_step = 0
            for p, acc in zip(self.params, self.acc):
                p.grad = acc.clone()
                acc.zero_()
        self._update([p.grad for p in self.params],
                     _f32(self.schedule(self.count)))
        self.count += 1
        return True

    def _update(self, grads, lr: float) -> None:
        """One optax.adamw update in optax's order: scale_by_adam,
        add_decayed_weights, scale_by_learning_rate, apply_updates."""
        b1, b2 = self.B1, self.B2
        n = np.float32(self.count + 1)
        bc1 = _f32(np.float32(1) - np.float32(b1) ** n)
        bc2 = _f32(np.float32(1) - np.float32(b2) ** n)
        # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - b2))
        # u = (mu / bc1) / (sqrt(nu / bc2) + eps) + wd p; p += -lr u
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(denom, self.EPS)
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc1), denom)
        del denom
        torch._foreach_add_(upd, torch._foreach_mul(self.params,
                                                    self.weight_decay))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(self.params, upd)


def make_optimizer(cfg: TrainConfig, model: nn.Module, steps_per_epoch: int,
                   *, freeze_prefixes: tuple[str, ...] = ()):
    """(AdamW over the trainable parameters, the cosine schedule). Frozen
    parameters are marked ``requires_grad=False`` and left out."""
    schedule = cosine_epoch_schedule(cfg.learning_rate, cfg.min_lr,
                                     cfg.cosine_max_epoch, steps_per_epoch)
    trainable = []
    for name, p in model.named_parameters():
        if is_frozen(name, freeze_prefixes):
            p.requires_grad_(False)
        else:
            trainable.append(p)
    return AdamW(trainable, schedule, cfg.weight_decay,
                 cfg.grad_accumulation), schedule
