"""The system under test, built from a configuration and a seed: the
port's models with the benchmark's weights (the same tensors the
reference computes with), and its tokenizer over the benchmark's
vocabulary."""
from __future__ import annotations

import torch

from cirbench.reference import blip as ref
from cirbench.traffic import cirr

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def port_configs(cfg: dict):
    from candidate_reranking_cir_tpu_torch.config import (
        RerankerModelConfig,
        RetrievalModelConfig,
        TextEncoderConfig,
        ViTConfig,
    )

    v, t = cfg["vit"], cfg["text"]
    vit = ViTConfig(image_size=v["image_size"], patch_size=v["patch_size"],
                    hidden_size=v["hidden_size"], num_layers=v["num_layers"],
                    num_heads=v["num_heads"], mlp_ratio=v["mlp_ratio"],
                    layer_norm_eps=v["layer_norm_eps"])
    text = TextEncoderConfig(
        vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
        num_layers=t["num_layers"], num_heads=t["num_heads"],
        intermediate_size=t["intermediate_size"],
        max_position_embeddings=t["max_position_embeddings"],
        encoder_width=t["encoder_width"], layer_norm_eps=t["layer_norm_eps"],
        hidden_dropout=t["hidden_dropout"],
        attention_dropout=t["attention_dropout"],
        merge_mlp_from=t["merge_mlp_from"])
    return (RetrievalModelConfig(vit=vit, text=text,
                                 embed_dim=cfg["embed_dim"],
                                 text_len=cfg["text_len"]),
            RerankerModelConfig(vit=vit, text=text,
                                text_len=cfg["text_len"]))


def build_stage1(cfg: dict, seed: int, device: str):
    """(the port's stage-I model, the benchmark's float32 weights)."""
    from candidate_reranking_cir_tpu_torch.models.blip_retrieval import (
        RetrievalModel,
    )

    weights = ref.make_weights(ref.stage1_shapes(cfg),
                               cirr.stream_seed(seed, "weights_stage1"),
                               device)
    model = RetrievalModel(port_configs(cfg)[0], dtype=DTYPES[cfg["dtype"]],
                           device=device)
    model.load_state_dict(weights, strict=True)
    return model.eval(), weights


def build_reranker(cfg: dict, seed: int, device: str):
    """(the port's re-ranker, the benchmark's float32 weights)."""
    from candidate_reranking_cir_tpu_torch.models.blip_reranker import (
        RerankerModel,
    )

    weights = ref.make_weights(ref.reranker_shapes(cfg),
                               cirr.stream_seed(seed, "weights_reranker"),
                               device)
    model = RerankerModel(port_configs(cfg)[1], dtype=DTYPES[cfg["dtype"]],
                          device=device)
    model.load_state_dict(weights, strict=True)
    return model.eval(), weights


def tokenizer():
    from candidate_reranking_cir_tpu_torch.models.tokenizer import (
        WordPieceTokenizer,
    )

    return WordPieceTokenizer.from_vocab_file(cirr.VOCAB_FILE)


class Capture:
    """Keeps the outputs of a module of the program as the timed path
    produces them (a forward hook that holds references, no copies);
    ``clear()`` at the start of each call keeps only the latest call's."""

    def __init__(self, module):
        self.outputs: list = []
        self.handle = module.register_forward_hook(self._hook)

    def _hook(self, module, args, output):
        self.outputs.append(output)

    def clear(self) -> None:
        self.outputs = []

    def close(self) -> None:
        self.handle.remove()
