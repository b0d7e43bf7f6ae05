"""The reference's tokenizer of the benchmark's captions: BERT's layout
([CLS] words [SEP]) with BLIP's [ENC] in place of [CLS] for the
image-grounded encoder (BLIP ``blip_stage1.py``), [DEC] and [ENC] appended
after the vocabulary as BLIP's ``init_tokenizer`` adds them. Every caption
word of the benchmark's traffic is a whole word of the vocabulary."""
from __future__ import annotations

import numpy as np

SEP = "[SEP]"


def encode(words: list[str], vocab: list[str]) -> tuple[np.ndarray,
                                                         np.ndarray]:
    """One caption's ids and mask, unpadded, [1, len(words) + 2]."""
    ids = {t: i for i, t in enumerate(vocab)}
    enc = len(vocab) + 1                       # [DEC], then [ENC]
    row = [enc, *(ids[w.lower()] for w in words), ids[SEP]]
    out = np.asarray([row], np.int64)
    return out, np.ones_like(out)
