"""Stage-I validation / top-k extraction CLI (port of the JAX package's
``cli/validate.py``; reference validate.py:342-445).

Examples:
  python -m candidate_reranking_cir_tpu_torch.cli.validate \
      --dataset CIRR --data-root /data --stage1-path ckpt.pt \
      --vocab vocab.txt --device cuda
  ... --save-topk --k 200 --topk-out cirr_top_200_val.npz
"""
from __future__ import annotations

import argparse
from pathlib import Path
from statistics import mean

from candidate_reranking_cir_tpu_torch.cli.common import (
    add_common_flags,
    build_stage1,
    get_tokenizer,
    get_mesh,
    get_transform,
    is_writer,
    load_params,
    mesh_requested,
    print_metrics,
    run_ranks,
)
from candidate_reranking_cir_tpu_torch.data.datasets import (
    CIRRDataset,
    FashionIQDataset,
)
from candidate_reranking_cir_tpu_torch.data.topk_io import save_topk_file
from candidate_reranking_cir_tpu_torch.retrieval.validate_engine import (
    evaluate_cirr_stage1,
    evaluate_fiq_stage1,
)
from candidate_reranking_cir_tpu_torch.runtime.host import (
    limit_numpy_threads,
)


def main(argv=None):
    limit_numpy_threads()
    parser = argparse.ArgumentParser()
    add_common_flags(parser)
    parser.add_argument("--stage1-path", type=str, required=True,
                        help="trained stage-I checkpoint (reference .pt)")
    parser.add_argument("--train", action="store_true",
                        help="validate on the train split")
    parser.add_argument("--save-topk", action="store_true")
    parser.add_argument("--k", default=200, type=int)
    parser.add_argument("--topk-out", type=str, default="",
                        help="output path for the top-k file (.npz or .pt)")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--q-batch", type=int, default=256,
                        help="fusion scheduler batch (decoupled from the "
                             "ViT embed batch)")
    parser.add_argument("--query-major-fusion", action="store_true",
                        help="disable the reference-image-major fusion "
                             "scheduler (the same function; for debugging "
                             "and A-B timing)")
    parser.add_argument("--single-program", action="store_true",
                        help="run the whole evaluation (corpus embed, "
                             "fusion, ranking) as one program: on the card "
                             "one CUDA-graph replay; needs the whole corpus "
                             "on the device; one device only")
    args = parser.parse_args(argv)
    if args.single_program and mesh_requested(args):
        parser.error("--single-program is single-device (drop --mesh)")
    if run_ranks(main, argv, args):
        return
    mesh = get_mesh(args)

    tokenizer = get_tokenizer(args)  # cheap fail-fast before ckpt IO
    model, cfg = build_stage1(args)
    params = load_params(args.stage1_path, 1, cfg)
    transform = get_transform(args)
    k = args.k if args.save_topk else None
    common = dict(text_len=args.text_len, batch_size=args.batch_size,
                  save_topk_k=k, q_batch=args.q_batch,
                  image_major=not args.query_major_fusion,
                  single_program=args.single_program, device=args.device,
                  mesh=mesh)

    if args.dataset.lower() == "cirr":
        split = "train" if args.train else "val"
        fv = args.train
        classic = CIRRDataset(args.data_root, split, "classic", transform,
                              force_validate=fv)
        relative = CIRRDataset(args.data_root, split, "relative", transform,
                               force_validate=fv)
        result, payload = evaluate_cirr_stage1(
            model, params, classic, relative, tokenizer, **common)
        print_metrics(result.metrics)
        if payload is not None and is_writer():
            out = args.topk_out or f"cirr_top_{args.k}_{split}.npz"
            payload["split"] = split
            save_topk_file(out, payload)
            print(f"top {args.k} saved at {out}.")

    elif args.dataset.lower() == "fashioniq":
        split = "train" if args.train else "val"
        fv = args.train
        r10s, r50s = [], []
        for dress in ("shirt", "dress", "toptee"):
            classic = FashionIQDataset(args.data_root, split, [dress],
                                       "classic", transform,
                                       force_validate=fv)
            relative = FashionIQDataset(args.data_root, split, [dress],
                                        "relative", transform,
                                        force_validate=fv)
            result, payload = evaluate_fiq_stage1(
                model, params, classic, relative, tokenizer,
                dress_types=[dress], **common)
            if is_writer():
                print(f"\n[{dress}]")
            print_metrics(result.metrics)
            r10s.append(result.metrics["recall_at10"])
            r50s.append(result.metrics["recall_at50"])
            if payload is not None and is_writer():
                if args.topk_out:
                    # one file per category: suffix the requested stem
                    out = (str(Path(args.topk_out).with_suffix(""))
                           + f"_{dress}.npz")
                else:
                    out = f"fiq_top_{args.k}_{split}_{dress}.npz"
                save_topk_file(out, payload)
                print(f"top {args.k} saved at {out}.")
        print_metrics({"\naverage recall10": mean(r10s),
                       "average recall50": mean(r50s),
                       "average total": (mean(r10s) + mean(r50s)) / 2})
    else:
        raise ValueError("Dataset should be either 'CIRR' or 'fashionIQ'")


if __name__ == "__main__":
    main()
