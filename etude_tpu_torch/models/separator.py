"""The source-separation U-Net in PyTorch (JAX counterpart:
etude_tpu/models/separator.py): a gated (GLU) double-conv masking U-Net.

Given a magnitude spectrogram it predicts per-stem ratio masks (5 stems:
vocals, drums, bass, piano, other) that sum to one across stems per TF bin.
Each encoder stage is a stride-2 conv and a refining conv, each a dense 5x5
conv followed by GroupNorm (in f32, over the largest divisor <= 8 of the
channel count) and a GLU; the decoder upsamples by 2 (nearest), convs, joins
the skip and convs again. The model sees only the first `freq_bins` rows;
rows above the band come back as uniform 1/num_stems masks.

Layout is NCHW ([B, C, T, F]) inside; the public `forward` keeps the JAX
signature (mag [B, T, F] → masks [B, stems, T, F]). Convs run in the compute
dtype (bf16 by default), as in the JAX package; parameters are f32 masters.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch
import torch.nn.functional as F
from torch import nn

STEM_NAMES = ("vocals", "drums", "bass", "piano", "other")


@dataclasses.dataclass(frozen=True)
class SeparatorConfig:
    num_stems: int = 5
    base_channels: int = 24
    depth: int = 5            # number of stride-2 encoder stages
    kernel: int = 5
    freq_bins: int = 1024     # model band (bins ≥ mel fmax get uniform masks)
    channel_cap: int = 192    # growth 2x per stage, capped


def _stage_channels(config: SeparatorConfig) -> List[int]:
    return [min(config.base_channels * (2 ** i), config.channel_cap)
            for i in range(config.depth)]


class _Conv(nn.Module):
    """A dense k x k 'same' conv, with GroupNorm over its output when `norm`."""

    def __init__(self, ci: int, co: int, k: int, norm: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(ci, co, k, padding=k // 2)
        self.norm = norm
        if norm:
            self.gn_scale = nn.Parameter(torch.ones(co))
            self.gn_bias = nn.Parameter(torch.zeros(co))

    def forward(self, h: torch.Tensor, dtype: torch.dtype, stride: int = 1,
                groups: int = 8) -> torch.Tensor:
        out = F.conv2d(h, self.conv.weight.to(dtype), self.conv.bias.to(dtype),
                       stride=stride, padding=self.conv.padding)
        if self.norm:
            C = out.shape[1]
            g = next(d for d in range(min(groups, C), 0, -1) if C % d == 0)
            out = F.group_norm(out.float(), g, self.gn_scale, self.gn_bias,
                               eps=1e-5).to(dtype)
        return out


def _glu(h: torch.Tensor) -> torch.Tensor:
    a, b = h.chunk(2, dim=1)
    return a * torch.sigmoid(b)


class Separator(nn.Module):
    def __init__(self, config: SeparatorConfig):
        super().__init__()
        self.config = config
        k = config.kernel
        chans = _stage_channels(config)
        self.enc = nn.ModuleList()
        ch = 1
        for co in chans:
            # GLU convs emit 2*co channels (value + gate halves).
            self.enc.append(nn.ModuleDict({"down": _Conv(ch, 2 * co, k),
                                           "ref": _Conv(co, 2 * co, k)}))
            ch = co
        self.dec = nn.ModuleList()
        for i in reversed(range(config.depth)):
            co = chans[i - 1] if i > 0 else config.base_channels
            skip_ch = chans[i - 1] if i > 0 else 1
            self.dec.append(nn.ModuleDict({"up": _Conv(ch, 2 * ch, k),
                                           "merge": _Conv(ch + skip_ch, 2 * co, k)}))
            ch = co
        self.mask_head = _Conv(ch, config.num_stems, k, norm=False)

    def forward(self, mag: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16
                ) -> torch.Tensor:
        """mag [B, T, F] magnitude (or log-magnitude) → ratio masks
        [B, num_stems, T, F] in f32 (softmax over stems)."""
        config, dtype = self.config, compute_dtype
        B, T, Fq = mag.shape
        band = min(Fq, config.freq_bins)
        mult = 2 ** config.depth
        h = F.pad(mag[:, :, :band], (0, (-band) % mult, 0, (-T) % mult))
        h = h[:, None].to(dtype)                              # [B, 1, T', F']

        skips = []
        for stage in self.enc:
            skips.append(h)
            h = _glu(stage["down"](h, dtype, stride=2))
            h = _glu(stage["ref"](h, dtype))
        for stage, skip in zip(self.dec, reversed(skips)):
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            h = _glu(stage["up"](h, dtype))
            h = _glu(stage["merge"](torch.cat([h, skip], dim=1), dtype))

        logits = self.mask_head(h, dtype).float()
        masks = torch.softmax(logits, dim=1)[:, :, :T, :band]
        if band < Fq:
            uniform = masks.new_full((B, config.num_stems, T, Fq - band),
                                     1.0 / config.num_stems)
            masks = torch.cat([masks, uniform], dim=-1)
        return masks
