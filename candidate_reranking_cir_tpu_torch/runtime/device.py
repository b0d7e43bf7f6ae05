"""Device resolution and float32 matmul policy for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. A missing
card is an error, never a quiet move to the CPU.
"""
from __future__ import annotations

import torch

# Full float32 in float32 products and convolutions, as the JAX reference
# computes them: TF32 keeps about three decimal digits, which the parity
# tolerances of the port do not allow. (Matmuls default to this already;
# cuDNN convolutions do not.)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """None means 'cuda'. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def sync_device(device: torch.device) -> None:
    """Wait for the card's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
