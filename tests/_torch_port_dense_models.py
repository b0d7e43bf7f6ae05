"""Small models of the port and one eval call of each, for the tests of
``Dense``'s kept casts (``tests/test_torch_port_dense.py`` on the CPU,
``tests/test_torch_port_cuda.py`` on the card). Heads are 64 wide (88 in
BLIP-2's ViT), the widths the card's kernels take. Imports no JAX.
"""
import torch

from candidate_reranking_cir_tpu_torch import config as tcfg

VOCAB = 120


def _vit(**kw):
    return tcfg.ViTConfig(image_size=32, patch_size=16, hidden_size=128,
                          num_layers=2, num_heads=2, **kw)


def _text(**kw):
    return tcfg.TextEncoderConfig(
        vocab_size=VOCAB, hidden_size=128, num_layers=2, num_heads=2,
        intermediate_size=256, encoder_width=kw.pop("encoder_width", 128),
        max_position_embeddings=32, **kw)


def _inputs(device, b: int, length: int, image_size: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    images = torch.randn(b, image_size, image_size, 3, generator=g)
    ids = torch.randint(3, VOCAB, (b, length), generator=g)
    mask = (torch.arange(length)[None] < torch.arange(b)[:, None] % length
            + 2).long()
    return images.to(device), ids.to(device), mask.to(device)


def retrieval(dtype, device):
    """Stage I: the ViT, the MED's fusion and both projections."""
    from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
        RetrievalModel,
    )

    model = RetrievalModel(tcfg.RetrievalModelConfig(
        vit=_vit(), text=_text(), embed_dim=32, text_len=8), dtype=dtype,
        device=device).eval()
    images, ids, mask = _inputs(device, 3, 8, 32, 0)

    def call():
        feats, pooled = model.embed_images(images, pool_and_normalize=True)
        return model.fuse(feats, ids, mask), pooled

    return model, call


def reranker(dtype, device):
    """Stage II: the ViT and the dual encoder in the per-pair layout (its
    stride-0 views of the text streams) and the candidate-major grid."""
    from candidate_reranking_cir_tpu_torch.models.blip_reranker import (
        RerankerModel,
    )

    model = RerankerModel(tcfg.RerankerModelConfig(
        vit=_vit(), text=_text(merge_mlp_from=1), text_len=8), dtype=dtype,
        device=device).eval()
    images, ids, mask = _inputs(device, 4, 8, 32, 1)
    g = torch.Generator().manual_seed(2)
    z_t = torch.randn(2, 8, 128, generator=g).to(device, dtype)

    def call():
        feats = model.embed_images(images)
        per_pair = model.score_per_query(
            z_t, ids[:2], mask[:2], feats.unflatten(0, (2, 2)))
        grid = model.score_grid(z_t[None].expand(2, -1, -1, -1),
                                ids[:2][None].expand(2, -1, -1),
                                mask[:2][None].expand(2, -1, -1), feats[:2])
        return per_pair, grid

    return model, call


def blip2(dtype, device):
    """BLIP-2: an EVA-style ViT (88-wide heads, q and v biases), the
    Q-Former's targets and its fusion."""
    from candidate_reranking_cir_tpu_torch.models.blip2_retrieval import (
        Blip2RetrievalModel,
    )

    cfg = tcfg.Blip2RetrievalModelConfig(
        vit=tcfg.ViTConfig(image_size=28, patch_size=14, hidden_size=176,
                           num_layers=2, num_heads=2, mlp_ratio=2.0,
                           qkv_bias="qv", final_norm_eps=1e-5),
        text=_text(encoder_width=176), num_query_tokens=4,
        cross_attention_freq=2, embed_dim=32, text_len=8)
    model = Blip2RetrievalModel(cfg, dtype=dtype, device=device).eval()
    images, ids, mask = _inputs(device, 2, 8, 28, 3)

    def call():
        feats, targets = model.embed_images(images, pool_and_normalize=True)
        return model.fuse(feats, ids, mask), targets

    return model, call


def caption(dtype, device):
    """The caption decoder: the ViT, the causal MED and the LM head."""
    from candidate_reranking_cir_tpu_torch.models.blip_decoder import (
        CaptionDecoder,
    )

    model = CaptionDecoder(tcfg.RetrievalModelConfig(
        vit=_vit(), text=_text()), dtype=dtype, device=device).eval()
    images, ids, mask = _inputs(device, 2, 8, 32, 4)
    return model, lambda: model(images, ids, mask)


def blip_base(dtype, device):
    """``BlipBase``: the ViT and the MED in multimodal mode."""
    from candidate_reranking_cir_tpu_torch.models.blip_base import BlipBase

    model = BlipBase(tcfg.RetrievalModelConfig(vit=_vit(), text=_text()),
                     dtype=dtype, device=device).eval()
    images, ids, mask = _inputs(device, 2, 8, 32, 5)
    return model, lambda: model(images, ids, mask)


MODELS = {"retrieval": retrieval, "reranker": reranker, "blip2": blip2,
          "caption": caption, "blip_base": blip_base}
