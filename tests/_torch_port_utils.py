"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_port_*).

Inputs are made with numpy and handed to both the JAX package and the port.
"""
import dataclasses

import jax
import numpy as np
import torch

from candidate_reranking_cir_tpu import config as jcfg
from candidate_reranking_cir_tpu_torch import config as tcfg

# tiny model widths (conftest's tiny configs, shrunk so the Pallas
# interpreter stays quick); encoder_width == hidden_size, as in BLIP
TINY_VIT = jcfg.ViTConfig(image_size=32, patch_size=8, hidden_size=24,
                          num_layers=2, num_heads=4)
TINY_TEXT = jcfg.TextEncoderConfig(
    vocab_size=256, hidden_size=24, num_layers=2, num_heads=4,
    intermediate_size=48, encoder_width=24, hidden_dropout=0.0,
    attention_dropout=0.0, merge_mlp_from=1)


def fused(cfg):
    """The JAX config with the Pallas kernels on (interpreted on the CPU)."""
    return dataclasses.replace(cfg, fused_attention=True)


def port_cfg(cfg):
    """JAX config dataclass -> the port's config of the same name."""
    cls = getattr(tcfg, type(cfg).__name__)
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(cfg, f.name)
        kw[f.name] = port_cfg(v) if dataclasses.is_dataclass(v) else v
    return cls(**kw)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t(x, dtype=None):
    """numpy -> CPU tensor (optionally cast)."""
    out = torch.from_numpy(np.array(x))  # writable copy
    return out.to(dtype) if dtype is not None else out


def f32(x) -> np.ndarray:
    """JAX array or tensor -> float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)
