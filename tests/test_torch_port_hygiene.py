"""Import hygiene and device policy of the PyTorch port.

- No module of the port, nor chip_smoke.py, imports jax, flax or the JAX
  package (an AST scan: the interpreter here may import jax at start-up,
  so sys.modules cannot tell).
- Entry points default to CUDA and raise without it; CPU tensors run the
  kernels' plain versions and leave the launch counters at 0.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from candidate_reranking_cir_tpu_torch import config as tcfg
from candidate_reranking_cir_tpu_torch.models.blip_reranker import (
    RerankerModel,
)
from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
    RetrievalModel,
)
from candidate_reranking_cir_tpu_torch.ops import attention as tattn
from candidate_reranking_cir_tpu_torch.ops import cuda_attention as ck
from candidate_reranking_cir_tpu_torch.retrieval import rerank
from candidate_reranking_cir_tpu_torch.retrieval.index import build_index
from candidate_reranking_cir_tpu_torch.retrieval.validate2_engine import (
    evaluate_cirr_stage2,
    evaluate_cirr_stage2_datasets,
)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "candidate_reranking_cir_tpu")
PORT_FILES = sorted((ROOT / "candidate_reranking_cir_tpu_torch").rglob("*.py"))

TINY_VIT = tcfg.ViTConfig(image_size=16, patch_size=8, hidden_size=16,
                          num_layers=1, num_heads=2)
TINY_TEXT = tcfg.TextEncoderConfig(vocab_size=64, hidden_size=16,
                                   num_layers=2, num_heads=2,
                                   intermediate_size=32, encoder_width=16,
                                   merge_mlp_from=1)


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module)
    return roots


@pytest.mark.parametrize(
    "path", PORT_FILES + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = {m for m in _imported_roots(path)
           if m.split(".")[0] in FORBIDDEN}
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_port_files_found():
    assert len(PORT_FILES) >= 15


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_require_cuda_by_default(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        RerankerModel(tcfg.RerankerModelConfig(vit=TINY_VIT, text=TINY_TEXT))
    with pytest.raises(RuntimeError, match="CUDA"):
        RetrievalModel(tcfg.RetrievalModelConfig(vit=TINY_VIT,
                                                 text=TINY_TEXT))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_index([], lambda x: x)
    with pytest.raises(RuntimeError, match="CUDA"):
        rerank.rerank_candidate_major(
            None, None, None, None, None, captions=[], reference_names=[],
            topk_names=np.zeros((0, 1)), index_feats=None, index_names=[],
            text_len=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_cirr_stage2_datasets(None, None, None, None, None, [], [],
                                      k=1, text_len=8)


def test_unported_options_raise():
    for kw in ({"schedule": "query_major"}, {"mesh": object()},
               {"shard_index": True}, {"index_int8": True}):
        with pytest.raises(NotImplementedError):
            evaluate_cirr_stage2(None, None, None, None, None, data_root="",
                                 transform=None, top_k_path="", k=1,
                                 text_len=8, device="cpu", **kw)


def test_cpu_models_count_no_launches():
    """A full CPU forward through every attention route (ViT and MED cross:
    K1; masked text: K2; candidate-major cross: K3; masked folded: K4)
    runs the plain versions only."""
    ck.reset_launch_counts()
    torch.manual_seed(0)
    s1 = RetrievalModel(tcfg.RetrievalModelConfig(
        vit=TINY_VIT, text=TINY_TEXT, embed_dim=8), device="cpu").eval()
    s2 = RerankerModel(tcfg.RerankerModelConfig(vit=TINY_VIT, text=TINY_TEXT),
                       device="cpu").eval()
    with torch.no_grad():
        feats = s2.embed_images(torch.zeros(2, 16, 16, 3))
        ids = torch.ones(2, 6, dtype=torch.int32)
        mask = torch.ones(2, 6, dtype=torch.int32)
        z = s1.fuse(feats, ids, mask, return_raw=True)
        s2.score_grid(z[:, None], ids[:, None], mask[:, None], feats)
        q = torch.zeros(2, 130, 32)
        tattn.dot_product_attention_folded(
            q, q, q, tattn.make_additive_mask(torch.ones(2, 130)),
            num_heads=2)
    assert ck.LAUNCHES == {"K1": 0, "K2": 0, "K3": 0, "K4": 0}


def test_resolve_device_rejects_other_devices():
    from candidate_reranking_cir_tpu_torch.runtime.device import (
        resolve_device,
    )

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
