"""Contrastive losses (port of the JAX package's
``parallel/contrastive.py``). One card: no all-gather."""
from __future__ import annotations

import torch


def cross_entropy_rows(logits, labels):
    """Row-wise cross-entropy over fp32 logits, the mean over rows (stage-II
    B x B loss, reference stage2_train.py:466-472)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[:, None]).mean()
