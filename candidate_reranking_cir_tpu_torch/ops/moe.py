"""Routed experts as grouped products, and their plain version.

``grouped_experts(x, idx, w, gate_up, down)`` runs one mixture-of-experts
layer's routed experts over the tokens x [T, D] that chose them (idx
[T, k] expert ids, w [T, k] float32 weights): every (token, slot) row is
sorted by its expert, the expert products run as two grouped products over
the experts' row groups (``torch._grouped_mm``: one launch for the stacked
gate and up projections [E, 2F, D], one for the down projection [E, D, F],
each group of rows against its own expert's weights), SwiGLU between them
in the compute dtype (``silu(gate) * up``, as DeepSeek-V3's modelling code
computes it) with each row scaled by its routing weight there (the down
projection is linear, so ``down(w h) = w down(h)``), and the rows go back
to (token, slot) order, summed over the slots in float32. No loop over
the experts: the group sizes stay on the device, so nothing waits for the
host. The same call runs on the CPU (``torch._grouped_mm`` has a CPU
form), in any float dtype.

``registry.MOE`` counts the rows routed ("routed", tokens x k, summed over
the layers that route) and the busiest expert's rows ("busiest", summed
over the same calls; a device tensor until read, so that counting costs no
sync). The imbalance of a run is ``busiest / (routed / E)``.

``grouped_experts_plain`` is the definition: each expert over its tokens
in turn (the reference's per-expert gather), for tests.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from candidate_reranking_cir_tpu_torch.ops.registry import MOE


def swiglu(gate, up, scale=None):
    """silu(gate) * up in their dtype, times ``scale`` [rows] if given."""
    h = F.silu(gate) * up
    return h if scale is None else h * scale[:, None].to(h.dtype)


def grouped_experts(x, idx, w, gate_up, down):
    """sum_i w[:, i] E_{idx[:, i]}(x): x [T, D], idx [T, k], w [T, k]
    float32, gate_up [E, 2F, D], down [E, D, F]; returns [T, D] float32."""
    t, k = idx.shape
    n_exp, width = gate_up.shape[0], down.shape[-1]
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=n_exp)
    offs = torch.cumsum(counts, 0, dtype=torch.int32)
    h = torch._grouped_mm(x[order // k], gate_up.transpose(-2, -1),
                          offs=offs)
    h = swiglu(h[:, :width], h[:, width:], w.reshape(-1)[order])
    o = torch._grouped_mm(h, down.transpose(-2, -1), offs=offs)
    # back to (token, slot) order: the inverse of the sort
    inv = torch.empty_like(order)
    inv[order] = torch.arange(len(order), device=order.device)
    MOE["routed"] += t * k
    MOE["busiest"] = MOE["busiest"] + counts.max()
    return o[inv].view(t, k, -1).sum(1, dtype=torch.float32)


def grouped_experts_plain(x, idx, w, gate_up, down):
    """``grouped_experts`` one expert at a time (its definition)."""
    width = down.shape[-1]
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(gate_up.shape[0]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if len(tok):
            h = x[tok] @ gate_up[e].t()
            h = swiglu(h[:, :width], h[:, width:], w[tok, slot])
            y.index_add_(0, tok, (h @ down[e].t()).float())
    return y
