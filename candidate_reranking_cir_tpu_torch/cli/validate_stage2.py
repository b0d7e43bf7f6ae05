"""Stage-II validation CLI (port of the JAX package's
``cli/validate_stage2.py``; reference validate_stage2.py:301-414).

Example:
  python -m candidate_reranking_cir_tpu_torch.cli.validate_stage2 \
      --dataset CIRR --data-root /data --stage1-path s1.pt \
      --stage2-path s2.pt --top-k-path cirr_top_200_val.npz --K-value 50 \
      --vocab vocab.txt --device cuda

``--schedule query_major`` (with ``--q-batch``) and ``--index-int8`` run;
``--shard-index`` splits the bank over the mesh (``--mesh auto`` on
several ranks; without a mesh it has no effect, as in the JAX CLI), and
``--index-int8`` with ``--shard-index`` is refused, as in the JAX CLI.
"""
from __future__ import annotations

import argparse

from candidate_reranking_cir_tpu_torch.cli.common import (
    add_common_flags,
    build_stage1,
    build_stage2,
    get_mesh,
    get_tokenizer,
    get_transform,
    is_writer,
    load_params,
    parse_l_buckets,
    print_metrics,
    run_ranks,
)
from candidate_reranking_cir_tpu_torch.retrieval.validate2_engine import (
    evaluate_cirr_stage2,
    evaluate_fiq_stage2,
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
                        help="stage-I top-k file; for Fashion-IQ a template "
                             "with '{dress}' or 'DTYPE'")
    parser.add_argument("--K-value", dest="k_value", type=int, default=50)
    parser.add_argument("--q-batch", type=int, default=8,
                        help="the query-major schedule's batch (unused by "
                             "the candidate-major one)")
    parser.add_argument("--schedule", type=str, default="candidate_major",
                        choices=["candidate_major", "query_major"],
                        help="re-rank scheduling: group pairs by candidate "
                             "(K/V amortized over the queries that rank each "
                             "corpus image) or by query ([Qb, K] chunks)")
    parser.add_argument("--shard-index", action="store_true",
                        help="shard the corpus feature bank over the mesh "
                             "(production layout for corpora beyond one "
                             "card's memory); needs --mesh auto and the "
                             "candidate_major schedule")
    parser.add_argument("--index-int8", action="store_true",
                        help="quantize the corpus feature bank to per-token "
                             "int8 (about half the memory; scores shift by "
                             "under 1%%, so off for parity runs)")
    parser.add_argument("--l-buckets", type=str, default="auto",
                        help="text-length buckets for the candidate-major "
                             "scheduler: 'auto' (length-percentile cuts), "
                             "'off' (single --text-len bucket), or a comma "
                             "list like '16,24,40'")
    args = parser.parse_args(argv)
    if args.index_int8 and args.shard_index:
        parser.error("--index-int8 and --shard-index are mutually exclusive "
                     "(quantize halves the bank instead of sharding it)")
    if run_ranks(main, argv, args):
        return
    mesh = get_mesh(args)

    tokenizer = get_tokenizer(args)  # cheap fail-fast before ckpt IO
    stage1, s1_cfg = build_stage1(args)
    reranker, s2_cfg = build_stage2(args)
    s1_params = load_params(args.stage1_path, 1, s1_cfg)
    s2_params = load_params(args.stage2_path, 2, s2_cfg)
    common = dict(data_root=args.data_root, transform=get_transform(args),
                  top_k_path=args.top_k_path, k=args.k_value,
                  text_len=args.text_len, q_batch=args.q_batch,
                  schedule=args.schedule,
                  l_buckets=parse_l_buckets(args.l_buckets),
                  index_int8=args.index_int8,
                  shard_index=args.shard_index and mesh is not None,
                  mesh=mesh, device=args.device)

    if args.dataset.lower() == "cirr":
        mets = evaluate_cirr_stage2(stage1, s1_params, reranker, s2_params,
                                    tokenizer, **common)
        print_metrics({**mets, "recall_mean": mets["mean_r5_rs1"]})
    elif args.dataset.lower() == "fashioniq":
        mets = evaluate_fiq_stage2(stage1, s1_params, reranker, s2_params,
                                   tokenizer, **common)
        print_metrics(mets)
    else:
        raise ValueError("Dataset should be either 'CIRR' or 'fashionIQ'")


if __name__ == "__main__":
    main()
