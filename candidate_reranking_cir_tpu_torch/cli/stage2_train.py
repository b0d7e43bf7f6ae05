"""Stage-II trainer CLI (port of the JAX package's ``cli/stage2_train.py``;
reference stage2_train.py:562-658).

Example:
  python -m candidate_reranking_cir_tpu_torch.cli.stage2_train \
      --dataset CIRR --data-root /data --vocab vocab.txt \
      --stage1-path models/s1/saved_models/blip_mean \
      --top-k-path cirr_top_50_val.npz --K-value 50 --device cuda

A frozen stage-I model (``--stage1-path``: a checkpoint directory of the
stage-I trainer, or a reference ``.pt``) produces z_t inside each step;
the dual-encoder re-ranker trains with CE over the B x B pair grid
(``runtime/train_steps.py::make_stage2_train_step``). The stage-II ViT
is frozen unless ``--blip-img-tune``. Checkpoints, ``--resume`` and
preemption as in ``cli/stage1_train.py``; validation re-ranks the
``--top-k-path`` file (``retrieval/validate2_engine.py``). Over several
ranks (``--mesh auto``, ``--fsdp``) as ``cli/stage1_train.py``: each rank
loads its block of each global batch, and the step shards the B x B pair
grid's candidates (``runtime/train_steps.py``).
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from candidate_reranking_cir_tpu_torch.cli.common import (
    add_common_flags,
    build_stage1,
    build_stage2,
    get_tokenizer,
    get_transform,
    load_params,
    parse_text_buckets,
    prescan_captions,
    print_metrics,
    run_ranks,
    text_bucket_slice,
)
from candidate_reranking_cir_tpu_torch.cli.stage1_train import (
    RankRun,
    add_train_flags,
    batch_captions,
    check_train_args,
    make_loggers,
    try_resume,
)
from candidate_reranking_cir_tpu_torch.config import TrainConfig
from candidate_reranking_cir_tpu_torch.data.datasets import (
    CIRRDataset,
    FashionIQDataset,
)
from candidate_reranking_cir_tpu_torch.data.loader import BatchLoader, prefetch
from candidate_reranking_cir_tpu_torch.retrieval.validate2_engine import (
    evaluate_cirr_stage2,
    evaluate_fiq_stage2,
)
from candidate_reranking_cir_tpu_torch.runtime.host import (
    GracefulShutdown,
    limit_numpy_threads,
)
from candidate_reranking_cir_tpu_torch.runtime.logging import make_comet
from candidate_reranking_cir_tpu_torch.runtime.optim import make_optimizer
from candidate_reranking_cir_tpu_torch.runtime.train_steps import (
    make_stage2_train_step,
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    add_common_flags(parser)
    add_train_flags(parser)
    parser.add_argument("--experiment-name", type=str, default="exp0_s2")
    parser.add_argument("--stage1-path", type=str, required=True,
                        help="trained stage-I checkpoint (a stage-I "
                             "trainer's checkpoint directory or a "
                             "reference .pt)")
    parser.add_argument("--pretrained", type=str, default="",
                        help="BLIP pretrain .pth for the stage-II init "
                             "(copied into both streams)")
    parser.add_argument("--top-k-path", type=str, required=True,
                        help="stage-I top-k file for validation")
    parser.add_argument("--K-value", dest="k_value", type=int, required=True)
    parser.add_argument("--num-epochs", default=100, type=int)
    parser.add_argument("--blip-max-epoch", default=80, type=int)
    parser.add_argument("--batch-size", default=16, type=int)
    parser.add_argument("--blip-img-tune", action="store_true",
                        help="finetune the stage-II ViT (default: frozen "
                             "feature extractor, stage2_train.py:445-452)")
    return parser.parse_args(argv)


def main(argv=None):
    limit_numpy_threads()
    args = parse_args(argv)
    dataset_name = check_train_args(args)
    if run_ranks(main, argv, args):
        return
    run = RankRun(args)
    if run.idle:
        return
    mesh = run.mesh

    tokenizer = get_tokenizer(args)  # cheap fail-fast before ckpt IO
    stage1, s1_cfg = build_stage1(args)
    torch.manual_seed(args.seed)     # the fresh initialization
    reranker, s2_cfg = build_stage2(args, remat=True)
    device = next(reranker.parameters()).device
    transform = get_transform(args)

    stage1.load_state_dict(load_params(args.stage1_path, 1, s1_cfg))
    if args.pretrained:
        reranker.load_state_dict(load_params(args.pretrained, 2, s2_cfg))

    train_cfg = TrainConfig(
        learning_rate=args.blip_learning_rate, weight_decay=args.weight_decay,
        cosine_max_epoch=args.blip_max_epoch,
        grad_accumulation=args.grad_accumulation_step)

    if dataset_name == "cirr":
        train_ds = CIRRDataset(args.data_root, "train", "relative", transform)
    else:
        train_ds = FashionIQDataset(args.data_root, "train",
                                    list(args.dress_types), "relative",
                                    transform)
    loader = BatchLoader(train_ds, args.batch_size, shuffle=True,
                         seed=args.seed, shard=run.shard)
    steps_per_epoch = max(len(loader), 1)
    prescan_captions(tokenizer, train_ds, args.text_len, dataset_name)

    # like the reference (stage2_train.py:96-99,138), a frozen ViT is
    # invisible to AdamW, whose weight decay would otherwise shrink it
    freeze = () if args.blip_img_tune else ("visual_encoder",)
    optimizer, schedule = make_optimizer(train_cfg, reranker, steps_per_epoch,
                                         freeze_prefixes=freeze, mesh=mesh,
                                         fsdp=args.fsdp)

    training_path = Path(args.output_dir) / args.experiment_name
    start_epoch, skip_batches = 0, 0
    if args.resume:
        start_epoch, skip_batches = try_resume(
            training_path / "saved_models" / "blip_last", reranker,
            optimizer, run)
    # per-epoch shuffle order is seed + epoch; align the loader's counter so
    # a resumed run sees the batch order the original run would have seen
    loader.epoch = start_epoch
    logger, comet = make_loggers(run, training_path, args,
                                 f"cir-stage2-{dataset_name}", make_comet)
    step_fn = make_stage2_train_step(stage1, reranker, optimizer,
                                     finetune_vit=args.blip_img_tune,
                                     mesh=mesh)
    text_buckets = parse_text_buckets(args.text_len_buckets, args.text_len)

    best_metric = -1.0
    stop = GracefulShutdown()
    for epoch in range(start_epoch, args.num_epochs):
        t0 = time.time()
        running_loss, seen, steps_done, stopped = 0.0, 0, 0, False
        for bi, batch in enumerate(prefetch(iter(loader), 2)):
            if epoch == start_epoch and bi < skip_batches:
                continue  # already applied before the preemption
            captions = batch_captions(batch, dataset_name, args.seed, epoch,
                                      bi, run.first_row(args.batch_size))
            ids, mask = tokenizer.encode(captions, args.text_len,
                                         set_enc_token=True)
            ids, mask = text_bucket_slice(ids, mask, text_buckets, mesh)
            loss = float(step_fn({
                "ref_images": batch["reference_image"].astype(np.float32),
                "target_images": batch["target_image"].astype(np.float32),
                "input_ids": ids, "attention_mask": mask,
            }, args.seed))
            running_loss += loss * ids.shape[0]
            seen += ids.shape[0]
            steps_done = bi + 1
            comet.log_metric("step_loss", loss, step=optimizer.micro_steps)
            if run.stop(stop.requested):
                stopped = True
                break
        if stopped:  # preemption: as in cli/stage1_train.py
            applied = max(steps_done,
                          skip_batches if epoch == start_epoch else 0)
            run.save(training_path / "saved_models" / "blip_last",
                     reranker, optimizer,
                     {"epoch": epoch - 1, "skip_batches": applied})
            run.log(f"preempted ({stop.signal_name or 'SIGTERM'}) at epoch "
                    f"{epoch}: resumable checkpoint saved; restart with "
                    "--resume")
            run.done()
            stop.restore()
            return
        epoch_loss = running_loss / max(seen, 1)
        run.log(f"[epoch {epoch}] loss={epoch_loss:.4f} "
                f"lr={float(schedule(epoch * steps_per_epoch)):.2e} "
                f"({time.time() - t0:.1f}s)")
        logger.log_train(epoch=epoch, train_epoch_loss=epoch_loss)
        comet.log_metric("epoch_loss", epoch_loss, epoch=epoch)

        if (epoch % args.validation_frequency == 0
                or epoch == args.num_epochs - 1):
            best_metric = run_validation(
                args, stage1, reranker, optimizer, tokenizer, transform,
                dataset_name, epoch, logger, comet, best_metric,
                training_path, run)
    stop.restore()
    run.log("training done")


def run_validation(args, stage1, reranker, optimizer, tokenizer, transform,
                   dataset_name, epoch, logger, comet, best_metric,
                   training_path, run: RankRun) -> float:
    """Re-rank the validation top-K file with the re-ranker as it stands
    on rank 0 (without a mesh, as the JAX trainer does), log the metrics,
    save ``blip_last`` and, on a new best, the best checkpoint; returns
    the best metric (rank 0's). Every rank calls it."""
    saved_dir = Path(training_path) / "saved_models"
    selection = None
    if run.writer:
        device = next(reranker.parameters()).device
        common = dict(data_root=args.data_root, transform=transform,
                      top_k_path=args.top_k_path, k=args.k_value,
                      text_len=args.text_len, device=device)
        if dataset_name == "cirr":
            mets = evaluate_cirr_stage2(stage1, None, reranker, None,
                                        tokenizer, **common)
            # a Python float: the checkpoint's metadata must load with
            # torch.load(weights_only=True), which refuses numpy scalars
            selection = float(mets["mean_r5_rs1"])
            ckpt_name = "blip_mean"
        else:
            mets = evaluate_fiq_stage2(stage1, None, reranker, None,
                                       tokenizer, **common)
            selection = float(mets["average_recall"])
            ckpt_name = "blip"
        print_metrics(mets)
        logger.log_validation(epoch=epoch, **mets)
        for k, v in mets.items():
            comet.log_metric(k, v, epoch=epoch)

    opt_state = optimizer.state_dict()
    run.save(saved_dir / "blip_last", reranker, optimizer, {"epoch": epoch},
             opt_state)
    if run.writer and selection > best_metric:
        best_metric = selection
        run.save(saved_dir / ckpt_name, reranker, optimizer,
                 {"epoch": epoch, "metric": selection}, opt_state)
        run.log(f"saved best ({ckpt_name}) at epoch {epoch}: "
                f"{selection:.2f}")
    run.done()
    return best_metric


if __name__ == "__main__":
    main()
