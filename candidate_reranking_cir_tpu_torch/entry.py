"""A one-card check of the flagship scoring path (the PyTorch form of the
JAX package's ``__graft_entry__.entry()``): the stage-II ViT embeds the
candidate images and the dual-stream encoder scores the (query x
candidate) pair grid, at the full ``RerankerModelConfig`` (ViT-B/16 at 384
px, 577 tokens; the 12-layer dual encoder) in bf16 with zero weights.

    from candidate_reranking_cir_tpu_torch.entry import entry
    fn, args = entry()            # on the card; entry("cpu") on the CPU
    scores = fn(*args)            # [2, 4]: queries x candidates

On the card it launches K1 (the ViT's 577-row self-attention) and the
dual encoder's eval kernels.

``dryrun_multichip(n)`` (``__graft_entry__.dryrun_multichip``'s
equivalent) runs every mesh path once at the JAX dry run's tiny configs
over a world of n ranks: a stage-II train step with ZeRO-style FSDP, a
stage-I step with the frozen-ViT mask and accumulation over two
micro-steps (the global-batch contrast), the sharded full ranking, the
candidate-major re-rank over a replicated, a block-sharded (equal to the
replicated within JAX's 1e-4) and an int8 bank, and the image-major
fusion. By default n NCCL ranks on n cards (it raises with fewer);
``device="cpu"`` runs n gloo processes, the port's form of JAX's re-exec
onto virtual CPU devices. Inside a process group of n ranks already (a
``torchrun`` launch, or one rank on one card) it runs in place.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from candidate_reranking_cir_tpu_torch.config import (
    RerankerModelConfig,
    RetrievalModelConfig,
    TextEncoderConfig,
    TrainConfig,
    ViTConfig,
)
from candidate_reranking_cir_tpu_torch.models.blip_reranker import (
    RerankerModel,
)
from candidate_reranking_cir_tpu_torch.runtime.device import resolve_device


def entry(device=None, cfg: RerankerModelConfig | None = None):
    """(fn, args): ``fn(*args)`` embeds 4 zero candidate images and scores
    them against 2 queries of ``cfg.text_len`` tokens, returning fp32
    [2, 4] scores. ``device``: default the card (raises without one);
    ``cfg``: default the full ``RerankerModelConfig``."""
    device = resolve_device(device)
    cfg = RerankerModelConfig() if cfg is None else cfg
    model = RerankerModel(cfg, dtype=torch.bfloat16, device=device).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()

    q, c, length = 2, 4, cfg.text_len
    size = cfg.vit.image_size
    images = torch.zeros(c, size, size, 3, device=device)
    input_ids = torch.zeros(q, length, dtype=torch.int32, device=device)
    mask = torch.ones(q, length, dtype=torch.int32, device=device)
    z_t = torch.zeros(q, length, cfg.text.hidden_size, device=device)

    def fn(images, input_ids, mask, z_t):
        with torch.inference_mode():
            feats = model.embed_images(images)
            return model.score_shared(z_t, input_ids, mask, feats)

    return fn, (images, input_ids, mask, z_t)


def tiny_configs() -> tuple[RetrievalModelConfig, RerankerModelConfig]:
    """The JAX dry run's stage-I and stage-II configs (ViT 32 px, width
    32, 4 heads; 4 text layers)."""
    vit = ViTConfig(image_size=32, patch_size=16, hidden_size=32,
                    num_layers=2, num_heads=4)
    text = TextEncoderConfig(vocab_size=128, hidden_size=32, num_layers=4,
                             num_heads=4, intermediate_size=64,
                             encoder_width=32, merge_mlp_from=2)
    return (RetrievalModelConfig(vit=vit, text=text, embed_dim=16,
                                 text_len=8),
            RerankerModelConfig(vit=vit, text=text, text_len=8))


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Every mesh path once over ``n_devices`` ranks (the module's
    docstring). Rank 0 prints ``dryrun_multichip(n): ok, loss=...``.
    Returns rank 0's figures: the stage-II and stage-I losses and the
    largest |sharded - replicated| re-rank logit."""
    device = resolve_device(device).type
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise RuntimeError(f"a world of {dist.get_world_size()} ranks "
                               f"cannot run dryrun_multichip({n_devices})")
        return _dryrun_impl(n_devices, device)
    from candidate_reranking_cir_tpu_torch.parallel.launch import run_world

    return run_world(_dryrun_impl, n_devices, device=device,
                     args=(n_devices, device), timeout_s=600.0)[0]


def _dryrun_impl(n: int, device: str) -> dict:
    from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
        RetrievalModel,
    )
    from candidate_reranking_cir_tpu_torch.models.tokenizer import (
        WordPieceTokenizer,
        build_test_vocab,
    )
    from candidate_reranking_cir_tpu_torch.ops.quant import quantize_bank
    from candidate_reranking_cir_tpu_torch.parallel.mesh import (
        make_mesh,
        shard_batch,
        shard_rows,
    )
    from candidate_reranking_cir_tpu_torch.retrieval.rerank import (
        rerank_candidate_major,
    )
    from candidate_reranking_cir_tpu_torch.retrieval.validate_engine import (
        full_ranking,
        make_stage1_fns,
        predict_queries,
    )
    from candidate_reranking_cir_tpu_torch.runtime.optim import (
        make_optimizer,
    )
    from candidate_reranking_cir_tpu_torch.runtime.train_steps import (
        make_stage1_train_step,
        make_stage2_train_step,
    )

    mesh = make_mesh(device=device)
    if mesh.size != n:
        raise RuntimeError(f"need {n} ranks, have {mesh.size}")
    dev = mesh.device
    s1_cfg, s2_cfg = tiny_configs()
    torch.manual_seed(0)  # the same weights on every rank
    s1 = RetrievalModel(s1_cfg, device=dev)
    s2 = RerankerModel(s2_cfg, device=dev)

    b, length = 2 * n, s2_cfg.text_len
    rng = np.random.default_rng(0)
    batch = shard_batch(mesh, {
        "ref_images": rng.normal(size=(b, 32, 32, 3)).astype(np.float32),
        "target_images": rng.normal(size=(b, 32, 32, 3)).astype(np.float32),
        "input_ids": rng.integers(4, 120, size=(b, length)).astype(np.int32),
        "attention_mask": np.ones((b, length), np.int32),
    })

    # dp for the batch; ZeRO-style FSDP for the stage-II optimizer moments
    opt, _ = make_optimizer(TrainConfig(), s2, 10, mesh=mesh, fsdp=True)
    loss = float(make_stage2_train_step(s1, s2, opt, mesh=mesh)(batch, 2))
    if not np.isfinite(loss) or opt.micro_steps != 1:
        raise RuntimeError(f"stage-II step: loss {loss}, "
                           f"{opt.micro_steps} steps")

    # stage I as its trainer builds it: the frozen-ViT mask and MultiSteps
    # accumulation, the global-batch contrast
    s1_opt, _ = make_optimizer(TrainConfig(grad_accumulation=2), s1, 10,
                               freeze_prefixes=("visual_encoder",),
                               mesh=mesh, fsdp=True)
    s1_step = make_stage1_train_step(s1, s1_opt, mesh=mesh)
    for _ in range(2):  # one full update
        s1_loss = float(s1_step(batch, 3))
    if not np.isfinite(s1_loss) or s1_opt.micro_steps != 2:
        raise RuntimeError(f"stage-I step: loss {s1_loss}, "
                           f"{s1_opt.micro_steps} micro-steps")

    # the eval paths: sharded ranking, candidate-major re-rank
    n_idx, n_q, k = 4 * n, 2 * n, 3
    pred = rng.normal(size=(n_q, s1_cfg.embed_dim)).astype(np.float32)
    pooled = torch.as_tensor(rng.normal(size=(n_idx, s1_cfg.embed_dim)),
                             dtype=torch.float32, device=dev)
    if full_ranking(pred, pooled, mesh=mesh).shape != (n_q, n_idx):
        raise RuntimeError("full_ranking shape")

    m_tokens = s2_cfg.vit.num_tokens
    bank = torch.as_tensor(
        rng.normal(size=(n_idx, m_tokens, s2_cfg.text.encoder_width)) * 0.05,
        dtype=torch.float32, device=dev)
    names = [f"im{i}" for i in range(n_idx)]
    tok = WordPieceTokenizer(build_test_vocab())
    tok.overflow = "truncate"
    kw = dict(
        # variable word counts: the text-length buckets across the mesh
        captions=[" ".join(["red"] * (1 + i % 5)) for i in range(n_q)],
        reference_names=[names[i % n_idx] for i in range(n_q)],
        topk_names=np.asarray([[names[(i + j + 1) % n_idx]
                                for j in range(k)] for i in range(n_q)]),
        index_names=names, text_len=s2_cfg.text_len, pairs_per_call=2 * n,
        q_buckets=(2, 4), zt_batch=n, mesh=mesh)
    out = rerank_candidate_major(s1, None, s2, None, tok, index_feats=bank,
                                 **kw)
    if out.logits.shape != (n_q, k) or not np.isfinite(out.logits).all():
        raise RuntimeError("replicated-bank re-rank")
    sharded = rerank_candidate_major(
        s1, None, s2, None, tok, index_feats=bank[shard_rows(mesh, n_idx)],
        index_sharded=True, **kw)
    gap = float(np.abs(sharded.logits - out.logits).max())
    if not gap <= 1e-4 + 1e-4 * float(np.abs(out.logits).max()):
        raise RuntimeError(f"sharded-bank logits differ by {gap}")
    int8 = rerank_candidate_major(s1, None, s2, None, tok,
                                  index_feats=quantize_bank(bank), **kw)
    if int8.logits.shape != (n_q, k) or not np.isfinite(int8.logits).all():
        raise RuntimeError("int8-bank re-rank")

    # stage-I eval fusion, image-major under the mesh
    _, fuse = make_stage1_fns(s1, None, dev)
    feats = torch.as_tensor(
        rng.normal(size=(n_idx, s1_cfg.vit.num_tokens,
                         s1_cfg.text.encoder_width)) * 0.05,
        dtype=torch.float32, device=dev)
    n_fq = 4 * n  # repeated references, so Q > 1 chunks form
    fpred = predict_queries(
        fuse, tok, [f"red {i % 3}" for i in range(n_fq)],
        [names[i % max(n_idx // 2, 1)] for i in range(n_fq)], feats, names,
        s1_cfg.text_len, q_batch=2 * n, mesh=mesh, image_major=True)
    if tuple(fpred.shape) != (n_fq, s1_cfg.embed_dim) \
            or not torch.isfinite(fpred).all():
        raise RuntimeError("image-major fusion")
    if mesh.rank == 0:
        print(f"dryrun_multichip({n}): ok, loss={loss:.4f}", flush=True)
    return {"loss": loss, "stage1_loss": s1_loss, "sharded_gap": gap}
