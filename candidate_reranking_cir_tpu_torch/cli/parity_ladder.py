"""Reference-parity ladder (port of the JAX package's
``cli/parity_ladder.py``): the gate that holds the port to the reference's
published artifacts once real weights and data are on the machine.

The reference's reproduction path (Instructions_CIRR.md): its
``blip_mean.pt``, stage-II checkpoint and ``cirr_top_200_val.pt``, then
validate.py and validate_stage2.py, then the test1 submissions
byte-compared with ``submission/CIRR/recall_*_0.json``. One invocation
runs the whole ladder on the port's engines:

  rung 0  the reference-code differential: recorded 'skip' (it runs the
          reference's own sources, which are not in the repository)
  rung 1  load the stage-I reference checkpoint      (--stage1-ckpt)
  rung 2  load the stage-II reference checkpoint     (--stage2-ckpt)
  rung 3  stage-I CIRR-val metrics + top-K extraction (--data-root)
  rung 4  top-K ordering vs the reference's top-k file (--reference-topk)
  rung 5  stage-II re-ranked CIRR-val metrics         (K = --K-value)
  rung 6  expected-metrics check                      (--expected JSON,
          |ours - published| <= --tolerance per metric)
  rung 7  test1 submissions, byte-diffed vs goldens   (--goldens-dir)

Rungs whose inputs are absent skip with the reason, so a partial artifact
set still gives a report. Exit code 1 if and only if a rung failed; the
JSON report goes to --report.

    python -m candidate_reranking_cir_tpu_torch.cli.parity_ladder \
        --dataset CIRR --data-root DATA --vocab vocab.txt \
        --stage1-ckpt blip_mean.pt --stage2-ckpt s2.pt \
        --reference-topk cirr_top_200_val.pt --goldens-dir submission/CIRR \
        --expected expected.json --device cuda
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from candidate_reranking_cir_tpu_torch.cli.common import (
    add_common_flags,
    build_stage1,
    build_stage2,
    get_mesh,
    get_tokenizer,
    get_transform,
    is_writer,
    load_params,
    run_ranks,
)
from candidate_reranking_cir_tpu_torch.parallel.mesh import barrier
from candidate_reranking_cir_tpu_torch.runtime.host import (
    limit_numpy_threads,
)

REFERENCE_DIFF_SKIP = ("the reference-code differential runs the "
                       "reference's own sources, which are not in the "
                       "repository; the port does not run it yet")


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    add_common_flags(parser)
    parser.add_argument("--stage1-ckpt", type=str, default="",
                        help="published stage-I checkpoint (blip_mean.pt / "
                             "blip.pt) or a trainer checkpoint directory")
    parser.add_argument("--stage2-ckpt", type=str, default="")
    parser.add_argument("--reference-topk", type=str, default="",
                        help="the reference's cirr_top_200_val.pt")
    parser.add_argument("--goldens-dir", type=str, default="",
                        help="directory holding recall_*_submission_*_0.json")
    parser.add_argument("--expected", type=str, default="",
                        help="JSON file {metric: published value}; rung 6 "
                             "checks |ours - published| <= --tolerance. "
                             "Unprefixed names are stage-I metrics; prefix "
                             "with rerank_ for stage-II (e.g. "
                             "rerank_recall_at1)")
    parser.add_argument("--tolerance", type=float, default=0.2)
    parser.add_argument("--k-extract", type=int, default=200)
    parser.add_argument("--K-value", dest="k_value", type=int, default=50)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--report", type=str, default="parity_report.json")
    parser.add_argument("--work-dir", type=str, default="parity_work")
    return parser.parse_args(argv)


class Ladder:
    def __init__(self):
        self.rungs: list[dict] = []

    def record(self, name: str, status: str, **detail):
        entry = {"rung": name, "status": status, **detail}
        self.rungs.append(entry)
        line = f"[{status.upper():4s}] {name}"
        if detail:
            line += " - " + json.dumps(detail, default=str)[:240]
        print(line, flush=True)
        return status != "fail"

    @property
    def failed(self):
        return any(r["status"] == "fail" for r in self.rungs)


def _compare_topk(ours: dict, theirs: dict, depth: int) -> dict:
    """Row-wise ordering agreement of two top-k payloads at the consumed
    depth (K = 50 for CIRR re-ranking). Rankings are name-level; both files
    store rows in dataset order."""
    a = np.asarray(ours["sorted_index_names"])[:, :depth]
    b = np.asarray(theirs["sorted_index_names"])[:, :depth]
    if a.shape != b.shape:
        return {"identical": False,
                "reason": f"shape {a.shape} vs {b.shape}"}
    exact_rows = float((a == b).all(axis=1).mean())
    overlap = float(np.mean([
        len(set(ra.tolist()) & set(rb.tolist())) / depth
        for ra, rb in zip(a, b)]))
    return {"identical": bool(exact_rows == 1.0),
            "exact_row_fraction": round(exact_rows, 6),
            "mean_set_overlap": round(overlap, 6)}


def _sub_cli_flags(args) -> list[str]:
    """The common flags the submission CLIs take, from the ladder's."""
    flags = ["--dataset", "CIRR", "--data-root", args.data_root,
             "--text-len", str(args.text_len),
             "--image-size", str(args.image_size),
             "--transform", args.transform,
             "--target-ratio", str(args.target_ratio),
             "--text-overflow", args.text_overflow,
             "--device", args.device, "--mesh", args.mesh]
    if not args.bf16:
        flags += ["--no-bf16"]
    if args.model_config:
        flags += ["--model-config", args.model_config]
    if args.vocab:
        flags += ["--vocab", args.vocab]
    elif getattr(args, "allow_test_vocab", False):
        flags += ["--allow-test-vocab"]
    return flags


def main(argv=None):
    limit_numpy_threads()
    args = parse_args(argv)
    if args.dataset.lower() != "cirr":
        raise ValueError("the ladder targets CIRR artifacts")
    if run_ranks(main, argv, args):
        return
    mesh = get_mesh(args)

    def written():
        """Rank 0's files, on every rank."""
        if mesh is not None:
            barrier(mesh)

    ladder = Ladder()
    work = Path(args.work_dir)
    work.mkdir(parents=True, exist_ok=True)

    tokenizer = get_tokenizer(args)
    transform = get_transform(args)

    # ---- rung 0: reference-code differential ------------------------------
    ladder.record("reference_differential", "skip",
                  reason=REFERENCE_DIFF_SKIP)

    # ---- rung 1/2: the reference checkpoints -------------------------------
    stage1, s1_cfg = build_stage1(args)
    s1_params = s2_params = reranker = None
    if args.stage1_ckpt:
        try:
            s1_params = load_params(args.stage1_ckpt, 1, s1_cfg)
            ladder.record("convert_stage1", "pass", params=int(sum(
                v.numel() for v in s1_params.values())))
        except Exception as e:  # noqa: BLE001 - the rung reports it
            ladder.record("convert_stage1", "fail", error=str(e))
    else:
        ladder.record("convert_stage1", "skip", reason="--stage1-ckpt unset")

    if args.stage2_ckpt:
        reranker, s2_cfg = build_stage2(args)
        try:
            s2_params = load_params(args.stage2_ckpt, 2, s2_cfg)
            ladder.record("convert_stage2", "pass", params=int(sum(
                v.numel() for v in s2_params.values())))
        except Exception as e:  # noqa: BLE001
            ladder.record("convert_stage2", "fail", error=str(e))
    else:
        ladder.record("convert_stage2", "skip", reason="--stage2-ckpt unset")

    # ---- rung 3: stage-I val metrics + top-K -------------------------------
    data_ok = (Path(args.data_root) / "cirr_dataset").exists()
    payload = None
    mets1 = {}
    if s1_params is not None and data_ok:
        from candidate_reranking_cir_tpu_torch.data.datasets import (
            CIRRDataset,
        )
        from candidate_reranking_cir_tpu_torch.data.topk_io import (
            save_topk_file,
        )
        from candidate_reranking_cir_tpu_torch.retrieval.validate_engine \
            import evaluate_cirr_stage1

        try:
            classic = CIRRDataset(args.data_root, "val", "classic", transform)
            relative = CIRRDataset(args.data_root, "val", "relative",
                                   transform)
            result, payload = evaluate_cirr_stage1(
                stage1, s1_params, classic, relative, tokenizer,
                text_len=args.text_len, batch_size=args.batch_size,
                save_topk_k=args.k_extract, device=args.device, mesh=mesh)
            mets1 = result.metrics
            if is_writer():
                save_topk_file(work / f"cirr_top_{args.k_extract}_val.npz",
                               payload)
            written()
            ladder.record("stage1_val", "pass",
                          **{k: round(v, 2) for k, v in mets1.items()})
        except Exception as e:  # noqa: BLE001
            ladder.record("stage1_val", "fail", error=str(e))
    else:
        ladder.record("stage1_val", "skip",
                      reason="needs --stage1-ckpt and cirr_dataset/ under "
                             "--data-root")

    # ---- rung 4: top-K ordering vs the reference's file --------------------
    if args.reference_topk and payload is not None:
        from candidate_reranking_cir_tpu_torch.data.topk_io import (
            load_topk_file,
        )

        try:
            theirs = load_topk_file(args.reference_topk)
            cmp = _compare_topk(payload, theirs, depth=args.k_value)
            ladder.record("topk_vs_reference",
                          "pass" if cmp.get("identical") else "fail", **cmp)
        except Exception as e:  # noqa: BLE001
            ladder.record("topk_vs_reference", "fail", error=str(e))
    else:
        ladder.record("topk_vs_reference", "skip",
                      reason="needs --reference-topk and rung 3")

    # ---- rung 5: stage-II re-ranked val metrics ----------------------------
    mets2 = {}
    topk_path = (args.reference_topk or
                 (str(work / f"cirr_top_{args.k_extract}_val.npz")
                  if payload is not None else ""))
    if s2_params is not None and s1_params is not None and data_ok \
            and topk_path:
        from candidate_reranking_cir_tpu_torch.retrieval.validate2_engine \
            import evaluate_cirr_stage2

        try:
            mets2 = evaluate_cirr_stage2(
                stage1, s1_params, reranker, s2_params, tokenizer,
                data_root=args.data_root, transform=transform,
                top_k_path=topk_path, k=args.k_value,
                text_len=args.text_len, batch_size=args.batch_size,
                device=args.device, mesh=mesh)
            ladder.record("stage2_val", "pass",
                          **{k: round(v, 2) for k, v in mets2.items()})
        except Exception as e:  # noqa: BLE001
            ladder.record("stage2_val", "fail", error=str(e))
    else:
        ladder.record("stage2_val", "skip",
                      reason="needs both ckpts, data, and a top-k file")

    # ---- rung 6: published-number check ------------------------------------
    if args.expected and (mets1 or mets2):
        expected = json.loads(Path(args.expected).read_text())
        # unprefixed names are stage-I metrics; stage-II metrics (which
        # share names like group_recall_at1) are rerank_<name>
        ours = {**{f"rerank_{k}": v for k, v in mets2.items()}, **mets1}
        deltas, missing = {}, []
        for k, v in expected.items():
            if k in ours:
                deltas[k] = round(abs(ours[k] - v), 3)
            else:
                missing.append(k)
        ok = not missing and all(d <= args.tolerance for d in deltas.values())
        ladder.record("expected_metrics", "pass" if ok else "fail",
                      deltas=deltas, missing=missing,
                      tolerance=args.tolerance)
    else:
        ladder.record("expected_metrics", "skip",
                      reason="needs --expected and metrics from rung 3/5")

    # ---- rung 7: test1 submissions byte-diffed vs goldens ------------------
    test1_ok = data_ok and (Path(args.data_root) / "cirr_dataset" / "cirr" /
                            "captions" / "cap.rc2.test1.json").exists()
    if args.goldens_dir and test1_ok and s1_params is not None:
        from candidate_reranking_cir_tpu_torch.cli import (
            cirr_test_submission,
            cirr_test_submission_stage2,
        )

        try:
            sub_dir = work / "submission"
            common = _sub_cli_flags(args)
            test1_topk = work / f"cirr_top_{args.k_extract}_test1.npz"
            cirr_test_submission.main(common + [
                "--stage1-path", args.stage1_ckpt,
                "--submission-name", "ladder_stage1",
                "--out-dir", str(sub_dir), "--save-topk",
                "--k", str(args.k_extract), "--topk-out", str(test1_topk),
                "--batch-size", str(args.batch_size)])
            pairs = [("recall_submission_ladder_stage1.json",
                      "recall_submission_stage1_0.json"),
                     ("recall_subset_submission_ladder_stage1.json",
                      "recall_subset_submission_stage1_0.json")]
            if s2_params is not None:
                cirr_test_submission_stage2.main(common + [
                    "--stage1-path", args.stage1_ckpt,
                    "--stage2-path", args.stage2_ckpt,
                    "--top-k-path", str(test1_topk),
                    "--K-value", str(args.k_value),
                    "--submission-name", "ladder_stage2",
                    "--out-dir", str(sub_dir),
                    "--batch-size", str(args.batch_size)])
                pairs += [("recall_submission_ladder_stage2.json",
                           "recall_submission_stage2_0.json"),
                          ("recall_subset_submission_ladder_stage2.json",
                           "recall_subset_submission_stage2_0.json")]
            written()
            diffs = {}
            for ours_name, golden_name in pairs:
                golden = Path(args.goldens_dir) / golden_name
                if not golden.exists():
                    diffs[golden_name] = "golden missing"
                    continue
                same = ((sub_dir / ours_name).read_bytes()
                        == golden.read_bytes())
                diffs[golden_name] = "identical" if same else "DIFFERS"
            ok = all(v == "identical" for v in diffs.values())
            ladder.record("golden_submissions", "pass" if ok else "fail",
                          **diffs)
        except Exception as e:  # noqa: BLE001
            ladder.record("golden_submissions", "fail", error=str(e))
    else:
        ladder.record("golden_submissions", "skip",
                      reason="needs --goldens-dir, test1 split, and ckpts")

    report = {"rungs": ladder.rungs, "failed": ladder.failed}
    if is_writer():
        Path(args.report).write_text(json.dumps(report, indent=2,
                                                default=str))
        print(f"report written to {args.report}")
    sys.exit(1 if ladder.failed else 0)


if __name__ == "__main__":
    main()
