"""The demixed dilated-transformer beat/downbeat activation model in PyTorch
(JAX counterpart: etude_tpu/models/beat_transformer.py).

A 3-stage conv/max-pool front-end collapses 128 mel bins to a dmodel-channel
sequence per stem; 9 pre-LN dilated-attention layers run over time
(dilation 2^layer, through ops/dilated_attention.py, the CUDA kernel on the
card), with instrument-axis attention over the 5 stems interleaved at layers
3-5; a (beat, downbeat) activation head averages over the stems, and a
300-class tempo head reads the summed attention-branch skips.

The numerics follow the JAX package: LayerNorm in f32 with f32 parameters,
convs and matmuls in the compute dtype (bf16 by default), softmaxes in f32,
both heads in f32. Parameters are f32 masters, cast per call.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dilated_attention import dilated_attention
from . import param_count  # noqa: F401  (re-exported, as in the JAX module)


@dataclasses.dataclass(frozen=True)
class BeatTransformerConfig:
    attn_len: int = 5
    instr: int = 5
    ntoken: int = 2
    dmodel: int = 256
    nhead: int = 8
    d_hid: int = 1024
    nlayers: int = 9
    mel_bins: int = 128
    n_tempi: int = 300
    # Instrument-axis attention is interleaved at these layer indices.
    instr_layers: Tuple[int, ...] = (3, 4, 5)
    # Reproduce the reference's head-7 key-slice training bug
    # (dilated_transformer_layer.py:52): needed only for weights trained
    # with it; the committed checkpoint was trained without.
    compat_head7_bug: bool = False


def _ln(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(x.dtype)


def _lin(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x, lin.weight.to(dtype), lin.bias.to(dtype))


class _InstrLayer(nn.Module):
    """Standard attention + ReLU FFN over the stem axis (pre-LN)."""

    def __init__(self, D: int, d_hid: int):
        super().__init__()
        self.q, self.k, self.v, self.o = (nn.Linear(D, D) for _ in range(4))
        self.ff1, self.ff2 = nn.Linear(D, d_hid), nn.Linear(d_hid, D)
        self.ln1, self.ln2 = nn.LayerNorm(D, eps=1e-5), nn.LayerNorm(D, eps=1e-5)


class _DilatedLayer(nn.Module):
    """Dilated time attention + exact-GELU FFN (pre-LN), with an optional
    instrument layer after it."""

    def __init__(self, config: BeatTransformerConfig, with_instr: bool):
        super().__init__()
        D, H = config.dmodel, config.nhead
        self.q, self.k, self.v = (nn.Linear(D, D) for _ in range(3))
        self.er = nn.Parameter(torch.zeros(H, D // H, config.attn_len))
        self.ff1, self.ff2 = nn.Linear(D, config.d_hid), nn.Linear(config.d_hid, D)
        self.ln1, self.ln2 = nn.LayerNorm(D, eps=1e-5), nn.LayerNorm(D, eps=1e-5)
        self.instr: Optional[_InstrLayer] = (
            _InstrLayer(D, config.d_hid) if with_instr else None)


class BeatTransformer(nn.Module):
    def __init__(self, config: BeatTransformerConfig):
        super().__init__()
        self.config = config
        D = config.dmodel
        # Conv front-end: (5,3)x32 → pool3 → (1,12)x64 → pool3 → (3,6)xD → pool3.
        self.conv1 = nn.Conv2d(1, 32, (5, 3))
        self.conv2 = nn.Conv2d(32, 64, (1, 12))
        self.conv3 = nn.Conv2d(64, D, (3, 6))
        self.layers = nn.ModuleList(
            _DilatedLayer(config, idx in config.instr_layers)
            for idx in range(config.nlayers))
        self.out = nn.Linear(D, config.ntoken)
        self.out_tempo = nn.Linear(D, config.n_tempi)

    def _frontend(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """[N, T, mel] → [N, T, dmodel]: NCHW convs, width max-pools, ReLU
        (mel 128 → 126 → 42 → 31 → 10 → 5 → 1)."""
        def block(h, conv, pad_h):
            h = F.conv2d(h, conv.weight.to(dtype), conv.bias.to(dtype),
                         padding=(pad_h, 0))
            return F.relu(F.max_pool2d(h, (1, 3), (1, 3)))

        h = block(x[:, None], self.conv1, 2)
        h = block(h, self.conv2, 0)
        h = block(h, self.conv3, 1)                  # [N, D, T, 1]
        return h[..., 0].transpose(1, 2).contiguous()

    def _instr_attention(self, h, p: _InstrLayer, B, instr, T, dtype):
        D, H = self.config.dmodel, self.config.nhead
        d = D // H
        hi = h.reshape(B, instr, T, D).transpose(1, 2).reshape(-1, instr, D)
        a_in = _ln(hi, p.ln1)

        def heads(lin):
            return _lin(a_in, lin, dtype).reshape(-1, instr, H, d).transpose(1, 2)

        qi, ki, vi = heads(p.q), heads(p.k), heads(p.v)
        scores = torch.einsum("nhqd,nhkd->nhqk", qi, ki).float()
        probs = torch.softmax(scores / math.sqrt(d), dim=-1).to(dtype)
        ctx = torch.einsum("nhqk,nhkd->nhqd", probs, vi)
        ctx = ctx.transpose(1, 2).reshape(-1, instr, D)
        hi = hi + _lin(ctx, p.o, dtype)
        hi = hi + _lin(F.relu(_lin(_ln(hi, p.ln2), p.ff1, dtype)), p.ff2, dtype)
        return hi.reshape(B, T, instr, D).transpose(1, 2).reshape(-1, T, D)

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, instr, T, mel_bins] → (activation logits [B, T, ntoken] f32,
        tempo logits [B, n_tempi] f32)."""
        config, dtype = self.config, compute_dtype
        B, instr, T, mel = x.shape
        D, H = config.dmodel, config.nhead
        d = D // H

        h = self._frontend(x.reshape(B * instr, T, mel).to(dtype), dtype)
        skips = None
        for idx, layer in enumerate(self.layers):
            a_in = _ln(h, layer.ln1)

            def heads(lin):
                return (_lin(a_in, lin, dtype).reshape(-1, T, H, d)
                        .transpose(1, 2).contiguous())

            attn = dilated_attention(heads(layer.q), heads(layer.k), heads(layer.v),
                                     layer.er.to(dtype), 2 ** idx,
                                     head7_bug=config.compat_head7_bug)
            sa = attn.transpose(1, 2).reshape(-1, T, D)
            h = h + sa
            h = h + _lin(F.gelu(_lin(_ln(h, layer.ln2), layer.ff1, dtype)),
                         layer.ff2, dtype)
            # Tempo-branch skip: the attention output, averaged over stems.
            skip = sa.reshape(B, instr, T, D).mean(dim=1)
            skips = skip if skips is None else skips + skip
            if layer.instr is not None:
                h = self._instr_attention(h, layer.instr, B, instr, T, dtype)

        h = F.relu(h).reshape(B, instr, T, D).mean(dim=1)
        act = F.linear(h.float(), self.out.weight, self.out.bias)
        t = F.relu(skips).mean(dim=1)
        tempo = F.linear(t.float(), self.out_tempo.weight, self.out_tempo.bias)
        return act, tempo


def loss_fn(model: BeatTransformer, batch: Dict[str, torch.Tensor],
            compute_dtype: torch.dtype = torch.bfloat16
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """BCE on the (beat, downbeat) activation logits plus cross-entropy on
    the tempo head (JAX `loss_fn` :202). Batch: x [B, instr, T, mel];
    activations [B, T, 2] in [0, 1]; tempo [B] int classes; optional mask
    [B, T], over which the BCE is a masked mean."""
    act_logits, tempo_logits = model(batch["x"], compute_dtype)
    target = batch["activations"]
    bce = -(target * F.logsigmoid(act_logits) + (1 - target) * F.logsigmoid(-act_logits))
    mask = batch.get("mask")
    if mask is not None:
        act_loss = (bce * mask[..., None]).sum() / (mask.sum() * 2).clamp(min=1)
    else:
        act_loss = bce.mean()
    tempo_logp = torch.log_softmax(tempo_logits, dim=-1)
    tempo_loss = -tempo_logp.gather(-1, batch["tempo"].long()[:, None]).mean()
    loss = act_loss + tempo_loss
    return loss, {"loss": loss, "act_bce": act_loss, "tempo_ce": tempo_loss}
