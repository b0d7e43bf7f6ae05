"""Stage-I CIRR test1 submission CLI (port of the JAX package's
``cli/cirr_test_submission.py``; reference cirr_test_submission.py).

Writes recall_submission_<name>.json (top-50 global, reference removed)
and recall_subset_submission_<name>.json (top-3 of each 6-image group),
optionally a test1 top-k file for stage-II re-ranking.

Example:
  python -m candidate_reranking_cir_tpu_torch.cli.cirr_test_submission \
      --dataset CIRR --data-root /data --stage1-path ckpt.pt \
      --vocab vocab.txt --submission-name s1 --save-topk --k 50 \
      --device cuda
"""
from __future__ import annotations

import argparse

import numpy as np

from candidate_reranking_cir_tpu_torch.cli.common import (
    add_common_flags,
    build_stage1,
    get_device,
    get_mesh,
    get_tokenizer,
    get_transform,
    is_writer,
    load_params,
    run_ranks,
)
from candidate_reranking_cir_tpu_torch.data.datasets import CIRRDataset
from candidate_reranking_cir_tpu_torch.data.topk_io import save_topk_file
from candidate_reranking_cir_tpu_torch.retrieval import metrics as M
from candidate_reranking_cir_tpu_torch.retrieval.index import build_index
from candidate_reranking_cir_tpu_torch.retrieval.submission import (
    build_submissions,
    write_submissions,
)
from candidate_reranking_cir_tpu_torch.retrieval.topk_writer import (
    test1_topk_payload,
)
from candidate_reranking_cir_tpu_torch.retrieval.validate_engine import (
    make_stage1_fns,
    predict_queries,
    ranked_slices,
)
from candidate_reranking_cir_tpu_torch.runtime.host import (
    limit_numpy_threads,
)


def main(argv=None):
    limit_numpy_threads()
    parser = argparse.ArgumentParser()
    add_common_flags(parser)
    parser.add_argument("--stage1-path", type=str, required=True)
    parser.add_argument("--submission-name", type=str, required=True)
    parser.add_argument("--out-dir", type=str, default="submission/CIRR")
    parser.add_argument("--save-topk", action="store_true")
    parser.add_argument("--k", type=int, default=50)
    parser.add_argument("--topk-out", type=str, default="")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--query-major-fusion", action="store_true",
                        help="disable the reference-image-major fusion "
                             "scheduler (the same function)")
    args = parser.parse_args(argv)
    if args.dataset.lower() != "cirr":
        parser.error("the test1 submission is CIRR's")
    if run_ranks(main, argv, args):
        return
    mesh = get_mesh(args)

    tokenizer = get_tokenizer(args)  # cheap fail-fast before ckpt IO
    model, cfg = build_stage1(args)
    params = load_params(args.stage1_path, 1, cfg)
    transform = get_transform(args)

    classic = CIRRDataset(args.data_root, "test1", "classic", transform)
    relative = CIRRDataset(args.data_root, "test1", "relative", transform)

    embed, fuse = make_stage1_fns(model, params, get_device(args))
    raw, pooled, index_names = build_index(classic, embed, args.batch_size,
                                           pooled=True, device=args.device,
                                           mesh=mesh)

    pair_ids, refs, captions, groups = [], [], [], []
    for i in range(len(relative)):
        s = relative[i]
        pair_ids.append(s["pair_id"])
        refs.append(s["reference_name"])
        captions.append(s["caption"])
        groups.append(s["group_members"])

    # the fusion batch is --batch-size, as in the JAX CLI
    pred = predict_queries(fuse, tokenizer, captions, refs, raw, index_names,
                           args.text_len, args.batch_size, mesh=mesh,
                           image_major=not args.query_major_fusion)
    # the submission consumes the top-50 and the top-k artifact only, never
    # the full order (validate_engine.ranked_slices)
    pos = {name: i for i, name in enumerate(index_names)}
    members = [[m for m in g if m != r][:5] for g, r in zip(groups, refs)]
    ent = np.asarray([[pos[r], *[pos[m] for m in row]]
                      for r, row in zip(refs, members)], np.int32)
    width = max(51, args.k + 1)
    topk_idx, ranks = ranked_slices(pred, pooled, width, ent, mesh=mesh)
    if not is_writer():
        return

    # remove the reference image from each row (cirr_test_submission.py:55-58)
    names_sliced = np.asarray(index_names, dtype=object)[topk_idx]
    names_wo_ref = M.remove_reference_column(names_sliced, ranks[:, 0])

    # subset ranking: the order of each query's group members within the
    # global ranking (cirr_test_submission.py:60-66)
    order = np.argsort(ranks[:, 1:], axis=1, kind="stable")
    group_sorted = np.take_along_axis(
        np.asarray(members, dtype=object), order, axis=1)

    submission, group_submission = build_submissions(pair_ids, names_wo_ref,
                                                     group_sorted)
    p1, p2 = write_submissions(args.out_dir, args.submission_name, submission,
                               group_submission)
    print(f"submissions saved at {p1} and {p2}")

    if args.save_topk:
        payload = test1_topk_payload(names_wo_ref, index_names, args.k)
        out = args.topk_out or f"cirr_top_{args.k}_test1.npz"
        save_topk_file(out, payload)
        print(f"top {args.k} saved at {out}.")


if __name__ == "__main__":
    main()
