"""What cuBLAS's reduced-precision bf16 sums do to the port's bf16 results.

    python -m candidate_reranking_cir_tpu_torch.tools.bf16_reduction

Runs on one CUDA card, from the repository root. PyTorch lets cuBLAS sum
a bf16 product's partial results in reduced precision unless
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`` is
False; the JAX reference's ``Dense`` asks for fp32 sums. With the flag
True and False in turns (True, False, False, True), it prints:

- the eval check of ``chip_smoke.py``'s eval phase: the bf16 card logits
  of the first scored queries' pairs against fp32 on the CPU (max |diff|),
  from the script's full-width random weights and synthetic workload;
- the bf16 stage-I loss on one batch of ``chip_smoke.py``'s stage-I
  traffic (B = 512, the MED in train mode with one seed table, so its
  dropout masks are fixed), against the same loss in fp32 on the card.

It leaves the flag as it found it. The last line is one JSON object of it
all.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

FLAG_ORDER = (True, False, False, True)


def _eval_errors(cs) -> list[dict]:
    from candidate_reranking_cir_tpu_torch.retrieval.index import build_index

    s1, s2 = cs.eval_models()
    corpus, queries, tok, skip = cs.eval_workload(s1.cfg.vit.image_size)
    bank, names = build_index(corpus, s2.embed_images, 16, device="cuda")
    ref = cs.rescore(s1, s2, tok, bank, names, queries, skip, torch.float32,
                     "cpu")
    out = []
    for flag in FLAG_ORDER:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            flag
        logits = cs.rescore(s1, s2, tok, bank, names, queries, skip,
                            torch.bfloat16, "cuda")
        err = float(np.abs(logits - ref).max())
        out.append({"flag": flag, "bf16_vs_fp32_cpu": err})
        print(f"[bf16-reduction] eval check, reduced-precision sums {flag}: "
              f"max |bf16 card - fp32 cpu| {err:.6e} (logit std "
              f"{float(ref.std()):.6e})", flush=True)
    return out


def _stage1_losses(cs) -> list[dict]:
    from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
        RetrievalModel,
    )
    from candidate_reranking_cir_tpu_torch.models.tokenizer import (
        WordPieceTokenizer,
        build_test_vocab,
    )
    from candidate_reranking_cir_tpu_torch.runtime.train_steps import (
        _to_device,
        draw_seeds,
        stage1_loss,
    )

    cfg = cs.stage1_config()
    torch.manual_seed(cs.SEED + 7)
    bf16 = RetrievalModel(cfg, dtype=torch.bfloat16, device="cuda")
    vocab = build_test_vocab()
    words = [w for w in vocab if w.isalpha() and len(w) > 1]
    pool = cs.Corpus(cs.S1_POOL, cfg.vit.image_size,
                     np.random.default_rng(cs.SEED + 8))
    cache = cs.target_cache(bf16, pool)
    batch = next(cs.stage1_batches(WordPieceTokenizer(vocab), words, pool,
                                   cache, 1, cs.S1_B))
    seeds = {"text": draw_seeds(torch.Generator().manual_seed(cs.SEED),
                                bf16.text_encoder.seed_shape)}

    def loss(model):
        with torch.no_grad():
            value, _ = stage1_loss(model, _to_device(batch, "cuda"), seeds,
                                   finetune_vit=False)
        return float(value)

    fp32 = RetrievalModel(cfg, device="cuda")
    fp32.load_state_dict(bf16.state_dict())
    ref = loss(fp32)
    del fp32
    out = []
    for flag in FLAG_ORDER:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            flag
        value = loss(bf16)
        out.append({"flag": flag, "loss": value, "fp32_loss": ref})
        print(f"[bf16-reduction] stage-I loss at B={cs.S1_B}, text width "
              f"{batch['input_ids'].shape[1]}, reduced-precision sums "
              f"{flag}: bf16 {value:.6f}, fp32 {ref:.6f}, |diff| "
              f"{abs(value - ref):.6e}", flush=True)
    return out


def main(argv=None) -> None:
    del argv
    if not torch.cuda.is_available():
        raise SystemExit("bf16_reduction: CUDA is not available")
    import chip_smoke as cs

    saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    print(f"[bf16-reduction] {cs.smi_name_and_limit()}; torch "
          f"{torch.__version__}; the flag's setting on entry: {saved}",
          flush=True)
    try:
        result = {"eval": _eval_errors(cs), "stage1": _stage1_losses(cs)}
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            saved
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
