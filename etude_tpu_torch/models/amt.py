"""The hFT transcription model of the Extract stage in PyTorch (JAX
counterpart: etude_tpu/models/amt.py, `AMTConfig` :35, `forward` :172).

A spectral front end (a window conv and a token embedding, folded into one
1 x n_proc filter with H outputs) over margin-padded log-mel segments; a
post-LN self-attention encoder over the 256 frequency bins; 88 note queries
that cross-attend to it (CAfreq) and give the first head set; then per-note
self-attention over time (SAtime) and the refined second head set. Heads:
onset, offset and frame (MPE) sigmoids and 128 velocity logits per
(frame, note).

The numerics follow the JAX package: matmuls in the compute dtype (bf16 on
the card, f32 on the CPU), layer norms in f32 with f32 parameters, the
attention softmax in f32 with its probabilities cast to the compute dtype
before PV, both head sets in f32. On the card the attention is
`F.scaled_dot_product_attention`, which keeps the same roundings without the
f32 score tensor the JAX package materialises (4.3 GB per group of 8
segments in the frequency encoder); on the CPU it is the explicit form.
Parameters are f32 masters, cast per call.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import param_count  # noqa: F401  (re-exported, as in the JAX module)


@dataclasses.dataclass(frozen=True)
class AMTConfig:
    n_margin: int = 32
    n_frame: int = 512           # frames per segment
    n_bin: int = 256
    cnn_channel: int = 4
    cnn_kernel: int = 5
    hid_dim: int = 256
    encoder_n_layer: int = 3
    encoder_n_head: int = 4
    decoder_n_layer: int = 3
    decoder_n_head: int = 4
    pf_dim: int = 512
    n_note: int = 88
    n_velocity: int = 128

    @property
    def n_proc(self) -> int:
        return 2 * self.n_margin + 1

    @property
    def conv_out(self) -> int:
        return self.n_proc - (self.cnn_kernel - 1)

    @property
    def cnn_dim(self) -> int:
        return self.cnn_channel * self.conv_out


HEADS = ("onset", "offset", "mpe")


def _ln(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(x.dtype)


def _lin(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x, lin.weight.to(dtype), lin.bias.to(dtype))


class _Attention(nn.Module):
    def __init__(self, H: int):
        super().__init__()
        self.q, self.k, self.v, self.o = (nn.Linear(H, H) for _ in range(4))


class _FeedForward(nn.Module):
    def __init__(self, H: int, P: int):
        super().__init__()
        self.inp, self.out = nn.Linear(H, P), nn.Linear(P, H)


def _layer_norms(H: int, n: int) -> nn.ModuleList:
    return nn.ModuleList(nn.LayerNorm(H, eps=1e-5) for _ in range(n))


class _EncoderLayer(nn.Module):
    def __init__(self, H: int, P: int):
        super().__init__()
        self.attn, self.ff, self.ln = _Attention(H), _FeedForward(H, P), _layer_norms(H, 2)


class _DecoderZero(nn.Module):
    def __init__(self, H: int, P: int):
        super().__init__()
        self.cross, self.ff, self.ln = _Attention(H), _FeedForward(H, P), _layer_norms(H, 2)


class _DecoderLayer(nn.Module):
    def __init__(self, H: int, P: int):
        super().__init__()
        self.self_attn, self.cross = _Attention(H), _Attention(H)
        self.ff, self.ln = _FeedForward(H, P), _layer_norms(H, 3)


class _Heads(nn.Module):
    def __init__(self, H: int, n_velocity: int):
        super().__init__()
        self.onset, self.offset, self.mpe = (nn.Linear(H, 1) for _ in range(3))
        self.velocity = nn.Linear(H, n_velocity)


def _mha(q_in: torch.Tensor, kv_in: torch.Tensor, p: _Attention, n_heads: int,
         dtype: torch.dtype) -> torch.Tensor:
    """Multi-head attention over [N, L, H] (JAX: `_mha` :142)."""
    N, Lq, H = q_in.shape
    Lk = kv_in.shape[1]
    d = H // n_heads
    q = _lin(q_in, p.q, dtype).view(N, Lq, n_heads, d).transpose(1, 2)
    k = _lin(kv_in, p.k, dtype).view(N, Lk, n_heads, d).transpose(1, 2)
    v = _lin(kv_in, p.v, dtype).view(N, Lk, n_heads, d).transpose(1, 2)
    if q.is_cuda:
        ctx = F.scaled_dot_product_attention(q, k, v)
    else:
        scores = (q @ k.transpose(-1, -2)).float()
        probs = torch.softmax(scores / math.sqrt(d), dim=-1).to(dtype)
        ctx = probs @ v
    return _lin(ctx.transpose(1, 2).reshape(N, Lq, H), p.o, dtype)


def _ffwd(x: torch.Tensor, p: _FeedForward, dtype: torch.dtype) -> torch.Tensor:
    return _lin(F.relu(_lin(x, p.inp, dtype)), p.out, dtype)


def _enc_layer(x: torch.Tensor, layer: _EncoderLayer, n_heads: int,
               dtype: torch.dtype) -> torch.Tensor:
    """Post-LN self-attention encoder layer (JAX: `_enc_layer` :165)."""
    x = _ln(x + _mha(x, x, layer.attn, n_heads, dtype), layer.ln[0])
    return _ln(x + _ffwd(x, layer.ff, dtype), layer.ln[1])


def _dec_layer(q: torch.Tensor, enc: torch.Tensor, layer: _DecoderLayer,
               n_heads: int, dtype: torch.dtype) -> torch.Tensor:
    """Post-LN note-query layer: self-attention, cross-attention to the
    frequency encoder, feed-forward (JAX: `dec_body` :238)."""
    q = _ln(q + _mha(q, q, layer.self_attn, n_heads, dtype), layer.ln[0])
    q = _ln(q + _mha(q, enc, layer.cross, n_heads, dtype), layer.ln[1])
    return _ln(q + _ffwd(q, layer.ff, dtype), layer.ln[2])


class HFT(nn.Module):
    """`forward(spec)` → both head sets, as the JAX `forward`."""

    def __init__(self, config: AMTConfig, n_time_pos: int = 0):
        """`n_time_pos` rows of the time position embedding (at least
        n_frame; a checkpoint trained at longer segments brings more, and
        the forward reads the first T)."""
        super().__init__()
        self.config = config
        H, P = config.hid_dim, config.pf_dim
        self.conv_w = nn.Parameter(torch.zeros(config.cnn_channel, config.cnn_kernel))
        self.conv_b = nn.Parameter(torch.zeros(config.cnn_channel))
        self.tok_emb = nn.Linear(config.cnn_dim, H)
        self.freq_pos_emb = nn.Parameter(torch.zeros(config.n_bin, H))
        self.enc_layers = nn.ModuleList(
            _EncoderLayer(H, P) for _ in range(config.encoder_n_layer))
        self.note_query = nn.Parameter(torch.zeros(config.n_note, H))
        self.dec_zero = _DecoderZero(H, P)
        self.dec_layers = nn.ModuleList(
            _DecoderLayer(H, P) for _ in range(config.decoder_n_layer - 1))
        self.heads_freq = _Heads(H, config.n_velocity)
        self.time_pos_emb = nn.Parameter(
            torch.zeros(max(n_time_pos, config.n_frame), H))
        self.time_layers = nn.ModuleList(
            _EncoderLayer(H, P) for _ in range(config.decoder_n_layer))
        self.heads_time = _Heads(H, config.n_velocity)

    def folded_frontend(self):
        """The window conv (C channels of K taps) followed by the token
        embedding over its C x conv_out outputs is linear, so it is one
        filter of n_proc taps with H outputs (JAX :195-215), folded in f32:
        Wf[u, h] = Σ_c Σ_{t+o=u} kern[c, t] · W_emb[(c, o), h]. Returns
        (Wf [n_proc, H], bias [H])."""
        c = self.config
        w_emb = self.tok_emb.weight.float().T.reshape(c.cnn_channel, c.conv_out, c.hid_dim)
        kern = self.conv_w.float()
        wf = torch.zeros(c.n_proc, c.hid_dim, device=kern.device)
        for t in range(c.cnn_kernel):
            wf[t:t + c.conv_out] += torch.einsum("c,coh->oh", kern[:, t], w_emb)
        bias = torch.einsum("c,coh->h", self.conv_b.float(), w_emb) + self.tok_emb.bias.float()
        return wf, bias

    def _apply_heads(self, h: torch.Tensor, heads: _Heads, B: int, T: int
                     ) -> Dict[str, torch.Tensor]:
        """[B·T, n_note, H] → sigmoids [B, T, n_note] and velocity logits
        [B, T, n_note, n_velocity], in f32 (JAX: `apply_heads` :257)."""
        hf = h.float()
        out = {name: torch.sigmoid(F.linear(hf, getattr(heads, name).weight,
                                            getattr(heads, name).bias)[..., 0]
                                   .reshape(B, T, -1))
               for name in HEADS}
        out["velocity"] = F.linear(hf, heads.velocity.weight, heads.velocity.bias
                                   ).reshape(B, T, -1, self.config.n_velocity)
        return out

    def forward(self, spec: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16,
                remat: bool = False) -> Dict[str, torch.Tensor]:
        """spec [B, n_bin, n_margin + T + n_margin] → {onset, offset, mpe}_
        {freq, time} sigmoids [B, T, n_note] and velocity_{freq, time} logits
        [B, T, n_note, n_velocity], T = n_frame.

        remat=True checkpoints every layer body of the frequency encoder,
        the note-query layers after the first and the time encoder
        (`torch.utils.checkpoint`, as the JAX forward's `jax.checkpoint` of
        its scanned bodies, :183-188): the backward recomputes them instead
        of keeping their attention and feed-forward intermediates."""
        c, dtype = self.config, compute_dtype

        def layer_call(fn, *args):
            if remat:
                return checkpoint(fn, *args, use_reentrant=False)
            return fn(*args)
        B = spec.shape[0]
        T, nbin, H = c.n_frame, c.n_bin, c.hid_dim

        # Front end as one matmul over the n_proc-frame windows of every
        # (frame, bin): [B, T, nbin, n_proc] @ [n_proc, H].
        wf, bias = self.folded_frontend()
        windows = spec.to(dtype).transpose(1, 2).unfold(1, c.n_proc, 1)
        x = (windows @ wf.to(dtype)) + bias.to(dtype)
        x = x * math.sqrt(H) + self.freq_pos_emb.to(dtype)

        # Frequency self-attention encoder over the bin axis.
        enc = x.reshape(B * T, nbin, H)
        for layer in self.enc_layers:
            enc = layer_call(_enc_layer, enc, layer, c.encoder_n_head, dtype)

        # CAfreq: the note queries cross-attend to the frequency axis.
        q = self.note_query.to(dtype)[None].expand(B * T, c.n_note, H)
        z = self.dec_zero
        q = _ln(q + _mha(q, enc, z.cross, c.decoder_n_head, dtype), z.ln[0])
        q = _ln(q + _ffwd(q, z.ff, dtype), z.ln[1])
        for layer in self.dec_layers:
            q = layer_call(_dec_layer, q, enc, layer, c.decoder_n_head, dtype)
        heads_a = self._apply_heads(q, self.heads_freq, B, T)

        # SAtime: per-note self-attention over the time axis.
        y = q.reshape(B, T, c.n_note, H).transpose(1, 2).reshape(B * c.n_note, T, H)
        y = y * math.sqrt(H) + self.time_pos_emb[:T].to(dtype)
        for layer in self.time_layers:
            y = layer_call(_enc_layer, y, layer, c.decoder_n_head, dtype)
        y = y.reshape(B, c.n_note, T, H).transpose(1, 2).reshape(B * T, c.n_note, H)
        heads_b = self._apply_heads(y, self.heads_time, B, T)

        out = {f"{k}_freq": v for k, v in heads_a.items()}
        out.update({f"{k}_time": v for k, v in heads_b.items()})
        return out


def loss_fn(model: HFT, batch: Dict[str, torch.Tensor],
            compute_dtype: torch.dtype = torch.bfloat16, remat: bool = False,
            pos_weights: Optional[Dict[str, float]] = None,
            head_scales: Optional[Dict[str, float]] = None,
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The hFT objective (JAX `loss_fn` :304): BCE on the onset, offset and
    MPE sigmoids (predictions clipped to [1e-7, 1 - 1e-7]) and cross-entropy
    on the velocity logits, over both head sets.

    Batch: spec [B, n_bin, margin + T + margin]; onset, offset, mpe
    [B, T, n_note] in [0, 1]; velocity [B, T, n_note] int classes.
    pos_weights: positive-class weights of the BCE per head ("onset",
    "offset", "mpe"), and the velocity CE's weights at sounding
    ("velocity") and silent ("velocity_silent") cells; head_scales: a
    multiplier per head on its loss terms. Both default to 1."""
    out = model(batch["spec"], compute_dtype, remat=remat)
    pos_weights = pos_weights or {}
    head_scales = head_scales or {}

    def bce(pred, target, pos_w):
        pred = pred.clamp(1e-7, 1 - 1e-7)
        return -(pos_w * target * torch.log(pred) + (1 - target) * torch.log(1 - pred)).mean()

    loss = 0.0
    metrics: Dict[str, torch.Tensor] = {}
    velocity = batch["velocity"].long()
    for branch in ("freq", "time"):
        for head in HEADS:
            term = bce(out[f"{head}_{branch}"], batch[head], pos_weights.get(head, 1.0))
            metrics[f"{head}_{branch}_bce"] = term
            loss = loss + head_scales.get(head, 1.0) * term
        logp = torch.log_softmax(out[f"velocity_{branch}"], dim=-1)
        vel_ll = logp.gather(-1, velocity[..., None])[..., 0]
        w = torch.where(velocity > 0, pos_weights.get("velocity", 1.0),
                        pos_weights.get("velocity_silent", 1.0)).to(vel_ll.dtype)
        term = -(vel_ll * w).sum() / w.sum().clamp(min=1e-6)
        metrics[f"velocity_{branch}_ce"] = term
        loss = loss + head_scales.get("velocity", 1.0) * term
    metrics["loss"] = loss
    return loss, metrics
