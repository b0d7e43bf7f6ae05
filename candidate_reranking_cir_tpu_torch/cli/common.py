"""Shared trainer plumbing (own copies of the JAX package's
``cli/common.py`` helpers that the ported train steps use): static
per-batch text-width buckets."""
from __future__ import annotations


def parse_text_buckets(spec: str, text_len: int) -> tuple[int, ...]:
    """Static per-batch text-width buckets for the trainers. 'auto' cuts at
    ~60%/80%/100% of ``text_len`` (multiples of 8); 'off' -> () keeps the
    single static bucket; else a comma list such as '24,32'."""
    if spec in ("off", "none"):
        return ()
    if spec == "auto":
        cand = {min(-(-int(text_len * f) // 8) * 8, text_len)
                for f in (0.6, 0.8)}
    else:
        cand = {int(b) for b in spec.split(",") if int(b) <= text_len}
    cand.add(text_len)
    return tuple(sorted(cand))


def text_bucket_slice(ids, mask, buckets: tuple[int, ...]):
    """Slice a pad-to-text_len batch (arrays or tensors) down to the
    smallest bucket holding its longest caption. The reference trains
    pad-to-longest per batch (blip_stage1.py:72); a fixed bucket set keeps
    the set of shapes small while recovering most of that saving. Numerics
    per real token are unchanged (pad keys are additively masked)."""
    if not buckets:
        return ids, mask
    max_len = int(mask.sum(axis=1).max())
    lb = next((b for b in buckets if b >= max_len), ids.shape[1])
    return ids[:, :lb], mask[:, :lb]
