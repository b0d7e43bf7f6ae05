"""Stage-I trainer CLI (port of the JAX package's ``cli/stage1_train.py``;
reference stage1_train.py:508-595).

Example:
  python -m candidate_reranking_cir_tpu_torch.cli.stage1_train \
      --dataset CIRR --data-root /data --vocab vocab.txt \
      --pretrained model_base.pth --experiment-name s1 --device cuda

The JAX trainer's flags (``--device``, default the card):
the step is ``runtime/train_steps.py::make_stage1_train_step`` fed by the
prefetching host loader. As in the JAX package:
- gradient accumulation keeps a running mean (``optax.MultiSteps``'s);
- checkpoints hold the full train state (``runtime/checkpoint.py``), so
  ``--resume`` continues a run exactly: the reference saves optimizer
  state but never reloads it;
- SIGTERM/SIGINT finish the current step, save a resumable ``blip_last``
  and return (``runtime/host.py::GracefulShutdown``).

Over several ranks (``--mesh auto``: torchrun's, or one rank a card that
the CLI starts; ``cli/common.py``) the run is JAX's data-parallel one:
``make_mesh_for_batch(--batch-size)``, each rank loading only its block
of each global batch, in the one-process order; the global-batch
contrast; the gradients averaged over the ranks, or with ``--fsdp``
reduce-scattered into ZeRO-style blocks of the moments
(``runtime/optim.AdamW``). A signal on any rank stops every rank at the
same step (the flag is all-reduced at each step boundary). Only rank 0
prints, logs, validates and writes checkpoints, which have the
one-process format, so a run saved at four ranks resumes at one.
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
    get_tokenizer,
    get_transform,
    is_writer,
    load_params,
    parse_text_buckets,
    prescan_captions,
    print_metrics,
    run_ranks,
    text_bucket_slice,
)
from candidate_reranking_cir_tpu_torch.config import TrainConfig
from candidate_reranking_cir_tpu_torch.data.captions import compose_fiq_train
from candidate_reranking_cir_tpu_torch.data.datasets import (
    CIRRDataset,
    FashionIQDataset,
)
from candidate_reranking_cir_tpu_torch.data.loader import BatchLoader, prefetch
from candidate_reranking_cir_tpu_torch.parallel import mesh as pmesh
from candidate_reranking_cir_tpu_torch.retrieval.index import build_index
from candidate_reranking_cir_tpu_torch.retrieval.validate_engine import (
    evaluate_cirr_stage1,
    evaluate_fiq_stage1,
    make_stage1_fns,
)
from candidate_reranking_cir_tpu_torch.runtime.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from candidate_reranking_cir_tpu_torch.runtime.host import (
    GracefulShutdown,
    limit_numpy_threads,
)
from candidate_reranking_cir_tpu_torch.runtime.logging import (
    CometStub,
    MetricsLogger,
    MetricsStub,
    make_comet,
)
from candidate_reranking_cir_tpu_torch.runtime.optim import make_optimizer
from candidate_reranking_cir_tpu_torch.runtime.train_steps import (
    make_stage1_train_step,
)


def add_train_flags(parser: argparse.ArgumentParser):
    """The flags both trainers share, after ``add_common_flags``."""
    parser.add_argument("--output-dir", type=str, default="models")
    parser.add_argument("--blip-learning-rate", default=2e-5, type=float)
    parser.add_argument("--grad-accumulation-step", default=1, type=int)
    parser.add_argument("--validation-frequency", default=1, type=int)
    parser.add_argument("--weight-decay", default=0.05, type=float)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--api-key", type=str, default="")
    parser.add_argument("--workspace", type=str, default="")
    parser.add_argument("--fsdp", action="store_true",
                        help="shard the optimizer moments over the mesh "
                             "(ZeRO-style; the parameters are gathered for "
                             "each step)")
    parser.add_argument("--resume", action="store_true",
                        help="resume from <output-dir>/<exp>/saved_models/"
                             "blip_last (the full train state, optimizer "
                             "included)")
    parser.add_argument("--text-len-buckets", type=str, default="auto",
                        help="per-batch text-width buckets (the reference "
                             "trains pad-to-longest per batch): 'auto' "
                             "(~60/80/100%% of --text-len), 'off', or a "
                             "comma list like '24,32'")
    return parser


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    add_common_flags(parser)
    add_train_flags(parser)
    parser.add_argument("--experiment-name", type=str, default="exp0")
    parser.add_argument("--pretrained", type=str, default="",
                        help="BLIP pretrain .pth to start from")
    parser.add_argument("--num-epochs", default=40, type=int)
    parser.add_argument("--blip-max-epoch", default=10, type=int,
                        help="cosine schedule period in epochs")
    parser.add_argument("--batch-size", default=512, type=int)
    parser.add_argument("--blip-bs", default=16, type=int,
                        help="batch of the target-feature cache's embed")
    parser.add_argument("--blip-img-tune", action="store_true",
                        help="finetune the ViT (default: frozen)")
    parser.add_argument("--no-cache-target-features", action="store_true",
                        help="disable the target-feature cache. By default "
                             "(frozen ViT, deterministic transforms) the "
                             "pooled target features of the train corpus "
                             "are embedded once and reused every epoch: the "
                             "same numbers, half of each step's ViT work "
                             "and half the image decodes saved")
    return parser.parse_args(argv)


def check_train_args(args) -> str:
    """Refuse what the trainers cannot run; returns the dataset's name."""
    name = args.dataset.lower()
    if name not in ("cirr", "fashioniq"):
        raise ValueError("Dataset should be either 'CIRR' or 'fashionIQ'")
    return name


def batch_captions(batch, dataset_name: str, seed: int, epoch: int,
                   index: int, first_row: int = 0) -> list[str]:
    """A train batch's captions. Fashion-IQ's random two-caption
    composition draws from a generator of (seed, epoch, batch index), so
    a resumed run composes what the uninterrupted run composed (the JAX
    trainer draws from one generator for the whole run). ``first_row``:
    the batch is a rank's block starting at that row of the global batch,
    whose earlier rows' draws are skipped, so every rank composes its
    rows as one process does."""
    if dataset_name == "cirr":
        return batch["caption"]
    rng = np.random.default_rng([seed, epoch, index])
    rng.random(first_row)  # one draw a row (compose_fiq_train)
    return compose_fiq_train(batch["captions"], rng)


class RankRun:
    """One rank's view of a trainer run: the training mesh (None on one
    process), whether this rank writes, the step-boundary stop flag and
    the checkpoint writes."""

    def __init__(self, args):
        self.mesh = None
        if args.mesh == "auto" and torch.distributed.is_initialized() \
                and torch.distributed.get_world_size() > 1:
            self.mesh = pmesh.make_mesh_for_batch(args.batch_size,
                                                  device=args.device)
        self.writer = is_writer()

    @property
    def idle(self) -> bool:
        """A rank outside a mesh that the batch shrank."""
        return self.mesh is not None and not self.mesh.member

    @property
    def shard(self):
        return None if self.mesh is None else (self.mesh.rank,
                                               self.mesh.size)

    def first_row(self, batch_size: int) -> int:
        return 0 if self.mesh is None \
            else self.mesh.rank * (batch_size // self.mesh.size)

    def stop(self, requested: bool) -> bool:
        """Whether any rank was asked to stop (an all-reduce of the flag
        over the mesh)."""
        if self.mesh is None:
            return requested
        flag = torch.tensor([int(requested)], device=self.mesh.device)
        return bool(pmesh.all_reduce(self.mesh, flag, "max").item())

    def save(self, path, model, optimizer, metadata: dict,
             opt_state=None) -> None:
        """The train state written by rank 0 (every rank calls this: a
        ZeRO-sharded optimizer's state is gathered collectively)."""
        if opt_state is None:
            opt_state = optimizer.state_dict()
        if self.writer:
            save_checkpoint(path, model, optimizer, metadata=metadata,
                            opt_state=opt_state)

    def done(self) -> None:
        """Every rank waits for rank 0's writes."""
        if self.mesh is not None:
            pmesh.barrier(self.mesh)

    def log(self, text: str) -> None:
        if self.writer:
            print(text, flush=True)


def tokenize_batch(tokenizer, captions, text_len):
    return tokenizer.encode(captions, text_len, set_enc_token=True)


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
    torch.manual_seed(args.seed)     # the fresh initialization
    model, cfg = build_stage1(args, remat=True)
    device = next(model.parameters()).device
    transform = get_transform(args)

    train_cfg = TrainConfig(
        learning_rate=args.blip_learning_rate, weight_decay=args.weight_decay,
        cosine_max_epoch=args.blip_max_epoch,
        grad_accumulation=args.grad_accumulation_step)

    cache_targets = not args.blip_img_tune \
        and not args.no_cache_target_features
    if dataset_name == "cirr":
        train_ds = CIRRDataset(args.data_root, "train", "relative", transform,
                               skip_target_image=cache_targets)
        classic_train = CIRRDataset(args.data_root, "train", "classic",
                                    transform)
    else:
        train_ds = FashionIQDataset(args.data_root, "train",
                                    list(args.dress_types), "relative",
                                    transform,
                                    skip_target_image=cache_targets)
        classic_train = FashionIQDataset(args.data_root, "train",
                                         list(args.dress_types), "classic",
                                         transform)
    loader = BatchLoader(train_ds, args.batch_size, shuffle=True,
                         seed=args.seed, workers=8, shard=run.shard)
    steps_per_epoch = max(len(loader), 1)
    prescan_captions(tokenizer, train_ds, args.text_len, dataset_name)

    if args.pretrained:
        model.load_state_dict(load_params(args.pretrained, 1, cfg))
    freeze = () if args.blip_img_tune else ("visual_encoder",)
    optimizer, schedule = make_optimizer(train_cfg, model, steps_per_epoch,
                                         freeze_prefixes=freeze, mesh=mesh,
                                         fsdp=args.fsdp)

    # target-feature cache: with a frozen ViT and deterministic transforms
    # the pooled target features are constant; embed the train corpus once
    # and gather per batch ([B, 256] in place of a second ViT pass). It is
    # made from the run's initial weights (the seeded init and
    # --pretrained) before a resume restores the checkpoint, so a resumed
    # run gathers the features the uninterrupted run gathered (the cache
    # went through vision_proj, which weight decay has moved since)
    tgt_pooled_np, tgt_pos = None, None
    if cache_targets:
        run.log("caching pooled target features for the train corpus...")
        embed, _ = make_stage1_fns(model, None, device)
        _, pooled, names = build_index(classic_train, embed, args.blip_bs,
                                       pooled=True, keep_raw=False,
                                       device=device, mesh=mesh)
        tgt_pooled_np = pooled.cpu().numpy()
        tgt_pos = {nm: i for i, nm in enumerate(names)}

    training_path = Path(args.output_dir) / args.experiment_name
    start_epoch, skip_batches = 0, 0
    if args.resume:
        start_epoch, skip_batches = try_resume(
            training_path / "saved_models" / "blip_last", model, optimizer,
            run)
    # per-epoch shuffle order is seed + epoch; align the loader's counter so
    # a resumed run sees the batch order the original run would have seen
    loader.epoch = start_epoch
    logger, comet = make_loggers(run, training_path, args,
                                 f"cir-stage1-{dataset_name}", make_comet)
    step_fn = make_stage1_train_step(model, optimizer,
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
            ids, mask = tokenize_batch(tokenizer, captions, args.text_len)
            ids, mask = text_bucket_slice(ids, mask, text_buckets, mesh)
            host_batch = {
                "ref_images": batch["reference_image"].astype(np.float32),
                "input_ids": ids, "attention_mask": mask,
            }
            if cache_targets:
                rows = np.asarray([tgt_pos[nm]
                                   for nm in batch["target_name"]])
                host_batch["target_pooled"] = tgt_pooled_np[rows]
            else:
                host_batch["target_images"] = \
                    batch["target_image"].astype(np.float32)
            loss = float(step_fn(host_batch, args.seed))
            running_loss += loss * ids.shape[0]
            seen += ids.shape[0]
            steps_done = bi + 1
            comet.log_metric("step_loss", loss, step=optimizer.micro_steps)
            if run.stop(stop.requested):
                stopped = True
                break
        if stopped:  # preemption: save a resumable state, return
            # epoch - 1 re-enters the interrupted epoch; skip_batches skips
            # the steps already inside the optimizer state, so nothing is
            # applied twice and the step-indexed LR schedule stays exact.
            # steps_done stays 0 while still replaying skips (possible when
            # the prior preemption hit the epoch's final batch), so a second
            # preemption never loses the recorded skip count.
            applied = max(steps_done,
                          skip_batches if epoch == start_epoch else 0)
            run.save(training_path / "saved_models" / "blip_last",
                     model, optimizer,
                     {"epoch": epoch - 1, "skip_batches": applied})
            run.log(f"preempted ({stop.signal_name or 'SIGTERM'}) at epoch "
                    f"{epoch}: resumable checkpoint saved; restart with "
                    "--resume")
            run.done()
            stop.restore()
            return
        epoch_loss = running_loss / max(seen, 1)
        lr = float(schedule(epoch * steps_per_epoch))
        run.log(f"[epoch {epoch}] loss={epoch_loss:.4f} lr={lr:.2e} "
                f"({time.time() - t0:.1f}s)")
        logger.log_train(epoch=epoch, train_epoch_loss=epoch_loss)
        comet.log_metric("epoch_loss", epoch_loss, epoch=epoch)
        comet.log_metric("epoch_lr", lr, epoch=epoch)

        if (epoch % args.validation_frequency == 0
                or epoch == args.num_epochs - 1):
            best_metric = run_validation(
                args, model, optimizer, tokenizer, transform, dataset_name,
                epoch, logger, comet, best_metric, training_path, run)
    stop.restore()
    run.log("training done")


def make_loggers(run: RankRun, training_path, args, project: str,
                 comet_factory):
    """(the CSV logger, Comet from ``comet_factory``) of rank 0; stubs on
    the other ranks."""
    if not run.writer:
        return MetricsStub(), CometStub()
    return (MetricsLogger(training_path, args.experiment_name, vars(args)),
            comet_factory(args.api_key or None, args.workspace or None,
                          project, args.experiment_name))


def try_resume(path, model, optimizer, run: RankRun) -> tuple[int, int]:
    """Restore the full train state in place from the checkpoint directory
    ``path``; returns (the epoch to start at, the batches of that epoch to
    skip). A mid-epoch preemption records the batches it had applied: the
    optimizer state holds them, so running them again would apply them
    twice and shift the step-indexed LR schedule. Batch order is fixed by
    (seed, epoch), so skipping reproduces the uninterrupted run."""
    path = Path(path)
    if not path.exists():
        run.log(f"no checkpoint at {path}; starting fresh")
        return 0, 0
    restored = restore_checkpoint(path, model, optimizer)
    epoch = restored.get("epoch", -1) + 1
    skip = int(restored.get("skip_batches", 0))
    extra = f", skipping {skip} already-applied batches" if skip else ""
    run.log(f"resumed from {path} at epoch {epoch} "
            f"(step {restored['step']}){extra}")
    return epoch, skip


def run_validation(args, model, optimizer, tokenizer, transform,
                   dataset_name, epoch, logger, comet, best_metric,
                   training_path, run: RankRun) -> float:
    """Validate the model as it stands on rank 0 (on its card, without a
    mesh, as the JAX trainer does), log the metrics, save ``blip_last``
    and, on a new best, the best checkpoint; returns the best metric
    (rank 0's). Every rank calls it."""
    saved_dir = Path(training_path) / "saved_models"
    selection = None
    if run.writer:
        selection, ckpt_name = validate_stage1(
            args, model, tokenizer, transform, dataset_name, epoch, logger,
            comet)
    opt_state = optimizer.state_dict()
    run.save(saved_dir / "blip_last", model, optimizer, {"epoch": epoch},
             opt_state)
    if run.writer and selection > best_metric:
        best_metric = selection
        run.save(saved_dir / ckpt_name, model, optimizer,
                 {"epoch": epoch, "metric": selection}, opt_state)
        run.log(f"saved best ({ckpt_name}) at epoch {epoch}: "
                f"{selection:.2f}")
    run.done()
    return best_metric


def validate_stage1(args, model, tokenizer, transform, dataset_name, epoch,
                    logger, comet) -> tuple[float, str]:
    """The validation metrics, printed and logged; returns (the selection
    metric, the best checkpoint's name)."""
    device = next(model.parameters()).device
    if dataset_name == "cirr":
        classic = CIRRDataset(args.data_root, "val", "classic", transform)
        relative = CIRRDataset(args.data_root, "val", "relative", transform)
        result, _ = evaluate_cirr_stage1(
            model, None, classic, relative, tokenizer,
            text_len=args.text_len, batch_size=32, device=device)
        mets = result.metrics
        selection = mets["mean_r5_rs1"]  # stage1_train.py:497-499
        ckpt_name = "blip_mean"
    else:
        r10s, r50s = [], []
        mets = {}
        for dress in ("shirt", "dress", "toptee"):
            classic = FashionIQDataset(args.data_root, "val", [dress],
                                       "classic", transform)
            relative = FashionIQDataset(args.data_root, "val", [dress],
                                        "relative", transform)
            result, _ = evaluate_fiq_stage1(
                model, None, classic, relative, tokenizer,
                text_len=args.text_len, batch_size=32, device=device)
            mets.update({f"{dress}_{k}": v for k, v in
                         result.metrics.items()})
            r10s.append(result.metrics["recall_at10"])
            r50s.append(result.metrics["recall_at50"])
        selection = (float(np.mean(r10s)) + float(np.mean(r50s))) / 2
        mets["average_recall"] = selection
        ckpt_name = "blip"

    print_metrics(mets)
    logger.log_validation(epoch=epoch, **mets)
    for k, v in mets.items():
        comet.log_metric(k, v, epoch=epoch)
    return selection, ckpt_name


if __name__ == "__main__":
    main()
