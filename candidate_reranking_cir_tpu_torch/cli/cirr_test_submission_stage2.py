"""Stage-II CIRR test1 submission CLI (port of the JAX package's
``cli/cirr_test_submission_stage2.py``; reference
cirr_test_submission_stage2.py).

Global ranking: the test1 top-k file's K candidate names re-sorted by the
re-ranker's score (cirr_test_submission_stage2.py:93-106); subset ranking:
the 5 non-reference group members re-scored by the same model.
``--schedule query_major`` (with ``--q-batch``) runs; ``--shard-index``
splits the bank over the mesh (no effect without one, as in the JAX CLI).

Example:
  python -m candidate_reranking_cir_tpu_torch.cli.cirr_test_submission_stage2 \
      --dataset CIRR --data-root /data --stage1-path s1.pt \
      --stage2-path s2.pt --top-k-path cirr_top_50_test1.npz \
      --vocab vocab.txt --submission-name s2 --device cuda
"""
from __future__ import annotations

import argparse

import numpy as np

from candidate_reranking_cir_tpu_torch.cli.common import (
    add_common_flags,
    build_stage1,
    build_stage2,
    get_device,
    get_mesh,
    get_tokenizer,
    get_transform,
    is_writer,
    load_params,
    parse_l_buckets,
    run_ranks,
)
from candidate_reranking_cir_tpu_torch.data.datasets import CIRRDataset
from candidate_reranking_cir_tpu_torch.retrieval.rerank import bind_module
from candidate_reranking_cir_tpu_torch.retrieval.submission import (
    build_submissions,
    write_submissions,
)
from candidate_reranking_cir_tpu_torch.retrieval.validate2_engine import (
    run_rerank,
    stage2_bank,
)
from candidate_reranking_cir_tpu_torch.runtime.host import (
    limit_numpy_threads,
)


def main(argv=None):
    limit_numpy_threads()
    parser = argparse.ArgumentParser()
    add_common_flags(parser)
    parser.add_argument("--stage1-path", type=str, required=True)
    parser.add_argument("--stage2-path", type=str, required=True)
    parser.add_argument("--top-k-path", type=str, required=True,
                        help="test1 top-k file from the stage-I submission")
    parser.add_argument("--K-value", dest="k_value", type=int, default=50)
    parser.add_argument("--submission-name", type=str, required=True)
    parser.add_argument("--out-dir", type=str, default="submission/CIRR")
    parser.add_argument("--q-batch", type=int, default=8,
                        help="the query-major schedule's batch (unused by "
                             "the candidate-major one)")
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--schedule", type=str, default="candidate_major",
                        choices=["candidate_major", "query_major"],
                        help="re-rank scheduling: by candidate or by query "
                             "([Qb, K] chunks)")
    parser.add_argument("--shard-index", action="store_true",
                        help="shard the corpus feature bank over the mesh "
                             "(needs --mesh auto and the candidate_major "
                             "schedule)")
    parser.add_argument("--l-buckets", type=str, default="auto",
                        help="text-length buckets for the candidate-major "
                             "scheduler: 'auto', 'off', or '16,24,40'")
    args = parser.parse_args(argv)
    if args.dataset.lower() != "cirr":
        parser.error("the test1 submission is CIRR's")
    if run_ranks(main, argv, args):
        return
    mesh = get_mesh(args)
    shard_index = args.shard_index and mesh is not None

    tokenizer = get_tokenizer(args)  # cheap fail-fast before ckpt IO
    stage1, s1_cfg = build_stage1(args)
    reranker, s2_cfg = build_stage2(args)
    s1_params = load_params(args.stage1_path, 1, s1_cfg)
    s2_params = load_params(args.stage2_path, 2, s2_cfg)
    transform = get_transform(args)

    classic = CIRRDataset(args.data_root, "test1", "classic", transform,
                          load_topk=args.top_k_path, k=args.k_value)
    relative = CIRRDataset(args.data_root, "test1", "relative", transform,
                           load_topk=args.top_k_path, k=args.k_value)

    device = get_device(args)
    stage1 = bind_module(stage1, s1_params, device)
    reranker = bind_module(reranker, s2_params, device)
    raw, index_names = stage2_bank(reranker, classic, args.batch_size, False,
                                   device, mesh, shard_index)

    samples = [relative[i] for i in range(len(relative))]
    pair_ids = [s["pair_id"] for s in samples]
    refs = [s["reference_name"] for s in samples]
    groups = [s["group_members"] for s in samples]
    topk_names = np.stack([np.asarray(s["topk_names"]) for s in samples])

    out = run_rerank(
        args.schedule, stage1, reranker, tokenizer, q_batch=args.q_batch,
        l_buckets=parse_l_buckets(args.l_buckets), device=device,
        mesh=mesh, shard_index=shard_index,
        captions=[s["caption"] for s in samples], reference_names=refs,
        topk_names=topk_names, index_feats=raw, index_names=index_names,
        text_len=args.text_len, group_members=groups)

    reranked_names = np.take_along_axis(
        np.asarray(topk_names, dtype=object), out.order, axis=1)
    members_no_ref = np.asarray(
        [[m for m in g if m != r][:5] for g, r in zip(groups, refs)],
        dtype=object)
    group_sorted = np.take_along_axis(members_no_ref, out.group_order, axis=1)

    if not is_writer():
        return
    submission, group_submission = build_submissions(
        pair_ids, reranked_names, group_sorted)
    p1, p2 = write_submissions(args.out_dir, args.submission_name, submission,
                               group_submission)
    print(f"submissions saved at {p1} and {p2}")


if __name__ == "__main__":
    main()
