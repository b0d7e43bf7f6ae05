"""How many times each hand-written kernel ran, and the one route that gives
a kernel's forward the gradients of its plain version.

Counters, by kernel id (``PERF.md`` §6 has the kernel table):

- ``EVAL``: K1-K4, the eval attention kernels (``ops/cuda_attention``);
- ``TRAIN``: K5-K9, the train attention kernels (``ops/attention_train``);
- ``WIDE``: K1's and K3's launches at 88-wide heads, "K1_d88" and
  "K3_d88", and at 72-wide ones, "K1_d72" and "K3_d72" (each also counted
  under its kernel id in ``EVAL``);
- ``FUSED``: G1, the bias + exact GELU (``ops/activation``), and G2, the
  residual add + LayerNorm (``ops/norm``);
- ``PLAIN_CALLS``: the calls of G1's and G2's entry points that took the
  plain version (no launch);
- ``DENSE``: the calls of ``models/layers.Dense`` that took its cached
  weight and bias in the compute dtype, "cached", and those that cast
  them first, "cast" (a new copy or a stale one). They count no kernel, so
  they are in no launch family and not in ``counts()``; the hit share is
  ``cached / (cached + cast)``. A parameter held in the compute dtype
  (Kimi-VL's) is a hit with nothing kept;
- ``MOE``: the mixture-of-experts layers' rows routed ("routed", tokens x
  experts per token) and their busiest expert's rows ("busiest"), each
  summed over the routed calls (``ops/moe``; "busiest" a device tensor
  until read);
- ``SDPA``: attention calls that ran ``F.scaled_dot_product_attention``
  (``ops/attention.sdpa_attention``), by kind: "mla", Kimi-VL's latent
  attention, whose head widths (192 for q and k, 128 for v) no kernel of
  the port takes.

``EVAL`` and ``TRAIN`` are also the attention modules' ``LAUNCHES``, the
two dicts whose sum the benchmark holds against the attention kernels of a
trace, so nothing else goes in them (``MOE`` and ``SDPA`` count work that
runs on no kernel of the port). A wrapper adds one to its counter
after each launch, a dict increment. ``reset()`` zeroes every counter in
place and ``counts()`` returns every kernel's launches.

``run(kernel, plain, *args)`` calls a kernel's forward directly unless
grad mode is on and a tensor argument requires grad; then it calls it
inside ``PlainBackward``, whose backward recomputes ``plain`` under
autograd, as the JAX package's ``custom_vjp`` backward recomputes with XLA.
So a call that wants no gradient (the eval paths, the frozen producers)
enters no autograd Function.
"""
from __future__ import annotations

import torch

EVAL = dict.fromkeys(("K1", "K2", "K3", "K4"), 0)
TRAIN = dict.fromkeys(("K5", "K6", "K7", "K8", "K9"), 0)
FUSED = dict.fromkeys(("G1", "G2"), 0)
WIDE = dict.fromkeys(("K1_d88", "K3_d88", "K1_d72", "K3_d72"), 0)
PLAIN_CALLS = dict.fromkeys(("G1", "G2"), 0)
DENSE = dict.fromkeys(("cast", "cached"), 0)
MOE = dict.fromkeys(("routed", "busiest"), 0)
SDPA = dict.fromkeys(("mla",), 0)
LAUNCH_FAMILIES = (EVAL, TRAIN, FUSED, WIDE)


def reset() -> None:
    for counters in (*LAUNCH_FAMILIES, PLAIN_CALLS, DENSE, MOE, SDPA):
        for key in counters:
            counters[key] = 0


def counts() -> dict:
    """Launches by kernel id since the last ``reset()``: K1-K9, G1, G2,
    K1_d88, K3_d88, K1_d72 and K3_d72."""
    return {k: n for counters in LAUNCH_FAMILIES for k, n in counters.items()}


class PlainBackward(torch.autograd.Function):
    """Forward: ``kernel(*args)``. Backward: ``plain(*args)``, the same
    function in plain PyTorch, recomputed under autograd; gradients for the
    tensor arguments that want one (None where ``plain`` does not use an
    argument)."""

    @staticmethod
    def forward(ctx, kernel, plain, *args):
        tensor = [torch.is_tensor(a) for a in args]
        ctx.save_for_backward(*(a if t else None
                                for a, t in zip(args, tensor)))
        ctx.plain = plain
        ctx.others = [None if t else a for a, t in zip(args, tensor)]
        return kernel(*args)

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[2:]
        inputs = [a if t is None else t.detach().requires_grad_(n)
                  for a, t, n in zip(ctx.others, ctx.saved_tensors, needs)]
        with torch.enable_grad():
            outs = ctx.plain(*inputs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], [t for t, n in zip(inputs, needs) if n],
                [g for _, g in pairs], allow_unused=True))
        return (None, None, *(next(got) if n else None for n in needs))


def run(kernel, plain, *args):
    """``kernel(*args)``, inside ``PlainBackward`` where grad mode is on and
    a tensor argument requires grad."""
    if torch.is_grad_enabled() and any(torch.is_tensor(a) and a.requires_grad
                                       for a in args):
        return PlainBackward.apply(kernel, plain, *args)
    return kernel(*args)
