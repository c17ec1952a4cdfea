"""Where the port runs: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(name: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`cuda` unless the caller asks for the CPU; raises without a GPU."""
    device = torch.device(name or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return device


def with_index(device: Union[str, torch.device]) -> torch.device:
    """`device` with its index: a bare `cuda` is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def compute_dtype_for(device: torch.device) -> torch.dtype:
    """bf16 on the card, as the JAX package's production calls run; f32 on
    the CPU, where the port is the reference its card runs are held to."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32
