"""The precisions the references run at: float32 with TF32 off, and the
float8 rounding that the precision controls put in the program's place."""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0   # the largest finite float8 e4m3


@contextlib.contextmanager
def exact_float32():
    """float32 products on the card: TF32 off for matmuls and convolutions."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8 e4m3 under one scale per tensor (its largest
    magnitude mapped to the format's largest), back in t's dtype."""
    amax = t.detach().abs().amax().clamp_min(1e-30)
    scale = FP8_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
