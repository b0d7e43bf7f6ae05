"""Rank workers of the port's mesh tests (tests/test_torch_port_mesh_*).

Each function runs on every rank of a world that
``parallel/launch.run_world`` spawns (gloo on the CPU, one thread a rank)
and returns picklable results. Spawned ranks import this module afresh, so
it imports only torch, numpy and the port: never JAX, which the test
modules import.
"""
import contextlib

import torch

from candidate_reranking_cir_tpu_torch.config import TrainConfig
from candidate_reranking_cir_tpu_torch.models.blip_reranker import (
    RerankerModel,
)
from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
    RetrievalModel,
)
from candidate_reranking_cir_tpu_torch.ops import attention_train
from candidate_reranking_cir_tpu_torch.parallel import mesh as pmesh
from candidate_reranking_cir_tpu_torch.runtime import train_steps
from candidate_reranking_cir_tpu_torch.runtime.optim import make_optimizer


@contextlib.contextmanager
def kernel_thresholds(thresholds):
    """``attention_train``'s MIN_KV and MIN_ROWS set to ``thresholds``
    (None: as they are) inside the block."""
    old = (attention_train.MIN_KV, attention_train.MIN_ROWS)
    if thresholds is not None:
        attention_train.MIN_KV, attention_train.MIN_ROWS = thresholds
    try:
        yield
    finally:
        attention_train.MIN_KV, attention_train.MIN_ROWS = old


@contextlib.contextmanager
def one_rank_mesh(store_dir):
    """A gloo process group of this process alone (a ``file://`` store in
    ``store_dir``) and its mesh, for the block; the group is destroyed
    after it."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store_dir}/store",
                            rank=0, world_size=1)
    try:
        yield pmesh.make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def train_case(case: dict, mesh):
    """One train case over ``mesh`` (None: one process, no mesh): fresh
    models from ``case``'s state dicts, ``case['steps']`` steps on the
    global batch (this rank's block of it under a mesh). Returns the
    losses, the trained parameters, the optimizer's state in the
    one-process format, this rank's moment bytes and the collectives
    issued by the steps."""
    s1 = RetrievalModel(case["s1_cfg"], device="cpu")
    s1.load_state_dict(case["s1_state"])
    model = s1
    if case["stage"] == 2:
        model = RerankerModel(case["s2_cfg"], device="cpu")
        model.load_state_dict(case["s2_state"])
    cfg = TrainConfig(learning_rate=case["lr"],
                      grad_accumulation=case.get("accumulation", 1))
    opt, _ = make_optimizer(cfg, model, 10,
                            freeze_prefixes=("visual_encoder",),
                            mesh=mesh, fsdp=case.get("fsdp", False))
    if case["stage"] == 1:
        step = train_steps.make_stage1_train_step(model, opt, mesh=mesh)
    else:
        step = train_steps.make_stage2_train_step(s1, model, opt, mesh=mesh)
    batch = case["batch"] if mesh is None \
        else pmesh.shard_batch(mesh, case["batch"])
    losses = []
    pmesh.reset_collective_counts()
    with kernel_thresholds(case.get("thresholds")):
        for _ in range(case["steps"]):
            losses.append(float(step(batch, case["seed"])))
    counts = dict(pmesh.COUNTS)
    state = opt.state_dict()
    return {"losses": losses,
            "params": {k: v.detach().clone()
                       for k, v in model.state_dict().items()},
            "mu": [m.clone() for m in state["mu"]],
            "moment_bytes": sum(m.numel() * m.element_size()
                                for m in opt.mu + opt.nu),
            "param_shapes": [tuple(p.shape) for p in opt.params],
            "moment_shapes": [tuple(m.shape) for m in opt.mu],
            "shard_dims": list(opt.shard_dims),
            "counts": counts}


def train_cases(cases: list) -> list:
    """Every case of ``cases`` over the world's mesh; each rank returns its
    results (the parameters only from rank 0)."""
    mesh = pmesh.make_mesh(device="cpu")
    out = []
    for case in cases:
        res = train_case(case, mesh)
        if mesh.rank:
            res = {k: v for k, v in res.items()
                   if k not in ("params", "mu")}
        out.append(res)
    return out


def call_each(calls: list) -> list:
    """Run ``fn(mesh, *args)`` for each (fn, args) of ``calls`` over the
    world's mesh; returns each call's result, with the collectives it
    issued (rank 0's results only: every rank returns the same)."""
    mesh = pmesh.make_mesh(device="cpu")
    out = []
    for fn, args in calls:
        pmesh.reset_collective_counts()
        res = fn(mesh, *args)
        out.append((res, dict(pmesh.COUNTS)))
    return out if mesh.rank == 0 else None


def run_clis(runs: list) -> list:
    """Each (module name, argv, kill_after) of ``runs``: the CLI's
    ``main(argv)`` on every rank, the trainers logging to a Comet
    stand-in that signals SIGTERM to this process after ``kill_after``
    step losses (rank 0's; None: never). Returns rank 0's step losses
    of each run."""
    import importlib

    from _torch_port_train_data import RecordingComet

    out = []
    for name, argv, kill_after in runs:
        comet = RecordingComet(kill_after)
        module = importlib.import_module(name)
        if hasattr(module, "make_comet"):
            module.make_comet = lambda *a, **k: comet
        module.main(argv)
        out.append(comet.losses)
    return out


# ---------------------------------------------------------------------------
# the eval paths: each takes the mesh (None: one process) first and returns
# the global result every rank gets

def models(spec: dict):
    """The stage-I and stage-II models of ``spec`` in eval mode."""
    s1 = RetrievalModel(spec["s1_cfg"], device="cpu")
    s1.load_state_dict(spec["s1_state"])
    s2 = RerankerModel(spec["s2_cfg"], device="cpu")
    s2.load_state_dict(spec["s2_state"])
    return s1.eval(), s2.eval()


def contrastive(mesh, pred, tgt, temp: float):
    """Each rank's (loss, logits) of its block, gathered: ([ranks] losses,
    [B, B] logits)."""
    from candidate_reranking_cir_tpu_torch.parallel.contrastive import (
        global_contrastive_loss,
    )

    p, t = (torch.from_numpy(pmesh.shard_batch(mesh, x)) for x in (pred, tgt))
    loss, logits = global_contrastive_loss(p, t, torch.tensor(temp), mesh)
    return (pmesh.all_gather(mesh, loss[None]).numpy(),
            pmesh.all_gather(mesh, logits).numpy())


def sharded_topk(mesh, pred, index, k: int):
    """``sharded_cosine_topk`` over the ranks' row blocks of ``index``."""
    from candidate_reranking_cir_tpu_torch.ops.topk import (
        sharded_cosine_topk,
    )

    block = torch.from_numpy(pmesh.shard_batch(mesh, index))
    scores, idx = sharded_cosine_topk(torch.from_numpy(pred), block, k, mesh)
    return scores.numpy(), idx.numpy()


def ranking(mesh, pred, pooled, width: int, ent):
    """(full_ranking, ranked_slices' topk and ranks)."""
    from candidate_reranking_cir_tpu_torch.retrieval import validate_engine

    pooled = torch.from_numpy(pooled)
    return (validate_engine.full_ranking(pred, pooled, mesh=mesh),
            *validate_engine.ranked_slices(pred, pooled, width, ent,
                                           mesh=mesh))


def full_ranking(mesh, pred, pooled):
    from candidate_reranking_cir_tpu_torch.retrieval import validate_engine

    return validate_engine.full_ranking(pred, torch.from_numpy(pooled),
                                        mesh=mesh)


def predict(mesh, spec: dict, captions, refs, feats, names, q_batch: int,
            image_major: bool):
    """``predict_queries`` with the stage-I model of ``spec``."""
    from candidate_reranking_cir_tpu_torch.models.tokenizer import (
        WordPieceTokenizer,
        build_test_vocab,
    )
    from candidate_reranking_cir_tpu_torch.retrieval import validate_engine

    s1, _ = models(spec)
    _, fuse = validate_engine.make_stage1_fns(s1, None, "cpu")
    return validate_engine.predict_queries(
        fuse, WordPieceTokenizer(build_test_vocab()), captions, refs,
        torch.from_numpy(feats), names, spec["s1_cfg"].text_len,
        q_batch=q_batch, mesh=mesh, image_major=image_major).numpy()


class ImageSet:
    """A classic dataset of in-memory images."""

    def __init__(self, images):
        self.images = images

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return {"name": f"im{i}", "image": self.images[i]}


def index(mesh, spec: dict, images, batch_size: int, shard_index: bool):
    """The stage-I ``build_index`` (raw bank with ``pooled``): (this rank's
    bank, pooled, names), the bank gathered over the ranks when sharded
    (rank order: the padded bank)."""
    from candidate_reranking_cir_tpu_torch.retrieval.index import build_index
    from candidate_reranking_cir_tpu_torch.retrieval.validate_engine import (
        make_stage1_fns,
    )

    s1, _ = models(spec)
    embed, _ = make_stage1_fns(s1, None, "cpu")
    bank, pooled, names = build_index(
        ImageSet(images), embed, batch_size, pooled=True,
        feature_dtype=torch.float32, device="cpu", mesh=mesh,
        shard_index=shard_index)
    blocks = pmesh.all_gather(mesh, bank[None]) if shard_index else bank
    return blocks.numpy(), pooled.numpy(), names


def rerank(mesh, spec: dict, kw: dict, schedule: str, bank, sharded=False,
           int8=False):
    """The stage-II re-rank (``schedule``) over ``bank`` (as a rank's
    block when ``sharded``, as an ``Int8Bank`` when ``int8``): (logits,
    group logits, order)."""
    from candidate_reranking_cir_tpu_torch.models.tokenizer import (
        WordPieceTokenizer,
        build_test_vocab,
    )
    from candidate_reranking_cir_tpu_torch.ops.quant import quantize_bank
    from candidate_reranking_cir_tpu_torch.retrieval import rerank as rr

    s1, s2 = models(spec)
    tok = WordPieceTokenizer(build_test_vocab())
    tok.overflow = "truncate"
    feats = torch.from_numpy(bank)
    if sharded:
        feats = feats[pmesh.shard_rows(mesh, len(feats))]
    if int8:
        feats = quantize_bank(feats)
    if schedule == "query_major":
        out = rr.rerank(s1, None, s2, None, tok, index_feats=feats, mesh=mesh,
                        device="cpu", **kw)
    else:
        out = rr.rerank_candidate_major(s1, None, s2, None, tok,
                                        index_feats=feats, mesh=mesh,
                                        index_sharded=sharded, device="cpu",
                                        **kw)
    return out.logits, out.group_logits, out.order


def fetch_rows(mesh, bank, rows):
    """The sharded bank's z_t reference fetch alone."""
    from candidate_reranking_cir_tpu_torch.retrieval.rerank import _fetch_rows

    block = torch.from_numpy(bank)[pmesh.shard_rows(mesh, len(bank))]
    return _fetch_rows(mesh, block, torch.as_tensor(rows),
                       len(bank) // mesh.size).numpy()


def stage1_eval(mesh, spec: dict, root: str, save_topk_k):
    """``evaluate_cirr_stage1`` on the CIRR tree at ``root``: (metrics,
    payload)."""
    from candidate_reranking_cir_tpu_torch.data.datasets import CIRRDataset
    from candidate_reranking_cir_tpu_torch.data.preprocessing import (
        make_transform,
    )
    from candidate_reranking_cir_tpu_torch.models.tokenizer import (
        WordPieceTokenizer,
        build_test_vocab,
    )
    from candidate_reranking_cir_tpu_torch.retrieval import validate_engine

    s1, _ = models(spec)
    tf = make_transform("targetpad", spec["s1_cfg"].vit.image_size)
    sets = [CIRRDataset(root, "val", mode, tf)
            for mode in ("classic", "relative")]
    result, payload = validate_engine.evaluate_cirr_stage1(
        s1, None, *sets, WordPieceTokenizer(build_test_vocab()),
        text_len=spec["s1_cfg"].text_len, batch_size=4, q_batch=8,
        save_topk_k=save_topk_k, device="cpu", mesh=mesh)
    return result.metrics, payload


def stage2_eval(mesh, spec: dict, root: str, topk_path: str, k: int,
                shard_index: bool, schedule: str):
    """``evaluate_cirr_stage2``'s metrics on the CIRR tree at ``root``."""
    from candidate_reranking_cir_tpu_torch.data.preprocessing import (
        make_transform,
    )
    from candidate_reranking_cir_tpu_torch.models.tokenizer import (
        WordPieceTokenizer,
        build_test_vocab,
    )
    from candidate_reranking_cir_tpu_torch.retrieval import validate2_engine

    s1, s2 = models(spec)
    tok = WordPieceTokenizer(build_test_vocab())
    tok.overflow = "truncate"
    return validate2_engine.evaluate_cirr_stage2(
        s1, None, s2, None, tok, data_root=root,
        transform=make_transform("targetpad", spec["s2_cfg"].vit.image_size),
        top_k_path=topk_path, k=k, text_len=spec["s2_cfg"].text_len,
        batch_size=4, q_batch=4, schedule=schedule, shard_index=shard_index,
        device="cpu", mesh=mesh)
