"""EtudeDecoder in PyTorch: the attribute-conditioned causal LM of the Decode
stage (JAX counterpart: etude_tpu/models/decoder.py).

Input embedding = word + class + projected concat of four attribute
embeddings; a GPT-NeoX-style backbone (parallel attention + MLP residual,
rotary embeddings on the first `rotary_pct` of each head, exact GELU); an
untied f32 LM head. The numerics follow the JAX package: LayerNorm in f32
with f32 parameters, matmuls in the compute dtype (bf16 by default), rotary
in f32, and the QKV projection split per head as [q_h | k_h | v_h]
(reshape to [B, T, H, 3D], then split). The embeddings have no
`padding_idx`: the JAX package trains the pad rows too (they are zero only
at init).

`forward_with_cache` (JAX :355) runs a chunk of tokens against a KV cache
for the rebuild engine (models/generate.py); its cache is [L, B, H, T, D],
so a layer's cache is the [B, H, C, D] the decode-attention kernel takes.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.decode_attention import decode_attention
from . import param_count  # noqa: F401  (re-exported, as in the JAX module)

# Attribute order is part of the data contract (concatenation order of the
# attribute embeddings before projection).
ATTRIBUTE_ORDER = ("pitch_overlap", "polyphony", "sustain", "rhythm_intensity")


@dataclasses.dataclass(frozen=True)
class EtudeDecoderConfig:
    vocab_size: int = 3000
    pad_token_id: int = 0
    hidden_size: int = 512
    num_hidden_layers: int = 8
    num_attention_heads: int = 8
    intermediate_size: int = 2048
    max_position_embeddings: int = 1024

    num_classes: int = 3
    pad_class_id: int = 0
    attribute_pad_id: int = 0
    context_num_past_xy_pairs: int = 4
    num_attribute_bins: int = 3
    attribute_emb_dim: int = 64

    rotary_pct: float = 0.25
    rotary_base: float = 10000.0
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.rotary_pct)

    def to_json_file(self, path: Union[str, Path]) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def from_json_file(cls, path: Union[str, Path]) -> "EtudeDecoderConfig":
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})


# ------------------------------------------------------------- primitives
def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm in f32 with f32 parameters, returned in x's dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(x.dtype)


def rotary_tables(config: EtudeDecoderConfig,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [max_pos, rotary_dim] (half-duplicated layout, matching
    the rotate-half convention), computed in f32 as the JAX package does."""
    rot = config.rotary_dim
    inv_freq = 1.0 / (
        config.rotary_base ** (np.arange(0, rot, 2, dtype=np.float32) / rot)
    )
    t = np.arange(config.max_position_embeddings, dtype=np.float32)
    freqs = np.outer(t, inv_freq)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return (torch.from_numpy(np.cos(emb)).to(device),
            torch.from_numpy(np.sin(emb)).to(device))


@functools.lru_cache(maxsize=8)
def _device_rotary_tables(config: EtudeDecoderConfig, device: torch.device):
    """`rotary_tables` made once per device: a training step must not copy
    from the host, which would synchronize it with the card."""
    return rotary_tables(config, device)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                  rotary_dim: int) -> torch.Tensor:
    """Rotary on the first rotary_dim dims of each head. x: [B, T, H, D];
    cos/sin: [T, rot] or [B, T, rot]."""
    x_rot, x_pass = x[..., :rotary_dim], x[..., rotary_dim:]
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    x_rot = x_rot * cos + _rotate_half(x_rot) * sin
    return torch.cat([x_rot, x_pass], dim=-1)


def masked_attention(q: torch.Tensor, k_l: torch.Tensor, v_l: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """Attention of S queries over a cache in plain PyTorch, mirroring the
    JAX einsums: bf16 operands, f32 scores and softmax, bf16 context.
    q [B, S, H, D] f32; k_l/v_l [B, H, C, D] bf16; bias [B, 1, S, C]."""
    scores = torch.einsum(
        "bqhd,bhcd->bhqc", q.bfloat16().float(), k_l.float()
    ) / math.sqrt(q.shape[-1])
    probs = torch.softmax(scores + bias, dim=-1)
    return torch.einsum("bhqc,bhcd->bqhd", probs.bfloat16(), v_l)


# ------------------------------------------------------------------ model
class DecoderLayer(nn.Module):
    def __init__(self, config: EtudeDecoderConfig):
        super().__init__()
        H, I = config.hidden_size, config.intermediate_size
        eps = config.layer_norm_eps
        self.ln1 = nn.LayerNorm(H, eps=eps)
        self.ln2 = nn.LayerNorm(H, eps=eps)
        self.qkv = nn.Linear(H, 3 * H)
        self.attn_out = nn.Linear(H, H)
        self.mlp_in = nn.Linear(H, I)
        self.mlp_out = nn.Linear(I, H)

    def cast(self, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        """The matmul weights in `dtype` (LayerNorm stays f32), made once so
        a decode loop does not re-read and re-cast f32 masters every step."""
        return {
            name: getattr(self, name).weight.to(dtype)
            for name in ("qkv", "attn_out", "mlp_in", "mlp_out")
        } | {
            f"{name}_b": getattr(self, name).bias.to(dtype)
            for name in ("qkv", "attn_out", "mlp_in", "mlp_out")
        }


def layer_step(layer: DecoderLayer, w: Dict[str, torch.Tensor],
               x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               config: EtudeDecoderConfig, attend) -> torch.Tensor:
    """One transformer layer (parallel residual). `w` holds the layer's
    matmul weights in the compute dtype; `attend(q, k, v)` takes q/k in f32
    after rotary and v in the compute dtype, each [B, S, H, D], and returns
    the context [B, S, H, D] in the compute dtype."""
    B, S, _ = x.shape
    n_heads, head_dim = config.num_attention_heads, config.head_dim
    a_in = _layer_norm(x, layer.ln1)
    qkv = F.linear(a_in, w["qkv"], w["qkv_b"]).view(B, S, n_heads, 3 * head_dim)
    q, k, v = qkv.split(head_dim, dim=-1)
    q = _apply_rotary(q.float(), cos, sin, config.rotary_dim)
    k = _apply_rotary(k.float(), cos, sin, config.rotary_dim)
    ctx = attend(q, k, v)
    attn_out = F.linear(ctx.reshape(B, S, -1), w["attn_out"], w["attn_out_b"])
    m_in = _layer_norm(x, layer.ln2)
    m = F.gelu(F.linear(m_in, w["mlp_in"], w["mlp_in_b"]), approximate="none")
    mlp_out = F.linear(m, w["mlp_out"], w["mlp_out_b"])
    return x + attn_out + mlp_out


class EtudeDecoder(nn.Module):
    """Parameters in PyTorch's layout ([out, in] linear weights, one module
    per layer); `weights.decoder_from_jax` fills them from the JAX tree."""

    def __init__(self, config: EtudeDecoderConfig):
        super().__init__()
        self.config = config
        H, A = config.hidden_size, config.attribute_emb_dim
        self.word_emb = nn.Embedding(config.vocab_size, H)
        self.class_emb = nn.Embedding(config.num_classes, H)
        self.attr_emb = nn.ModuleDict({
            name: nn.Embedding(config.num_attribute_bins, A)
            for name in ATTRIBUTE_ORDER
        })
        self.attr_proj = nn.Linear(len(ATTRIBUTE_ORDER) * A, H)
        self.layers = nn.ModuleList(
            DecoderLayer(config) for _ in range(config.num_hidden_layers)
        )
        self.final_ln = nn.LayerNorm(H, eps=config.layer_norm_eps)
        self.lm_head = nn.Linear(H, config.vocab_size, bias=False)

    # ---- embedding -----------------------------------------------------
    def embed_class_attrs(self, class_ids: torch.Tensor,
                          attr_ids: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Class + projected-attribute part of the input embedding
        ([B, T, hidden] f32); constant across a bar's decode steps, so the
        stream engine computes it once per bar."""
        attrs = torch.cat(
            [self.attr_emb[name](attr_ids[name]) for name in ATTRIBUTE_ORDER],
            dim=-1,
        )
        return self.class_emb(class_ids) + self.attr_proj(attrs)

    def embed_inputs(self, input_ids: torch.Tensor, class_ids: torch.Tensor,
                     attr_ids: Dict[str, torch.Tensor],
                     compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        return (self.word_emb(input_ids)
                + self.embed_class_attrs(class_ids, attr_ids)).to(compute_dtype)

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """Final LayerNorm, then the f32 LM head → f32 logits."""
        h = _layer_norm(h, self.final_ln)
        return F.linear(h.float(), self.lm_head.weight)

    # ---- full-sequence forward -------------------------------------------
    def forward(self, input_ids: torch.Tensor, class_ids: torch.Tensor,
                attr_ids: Dict[str, torch.Tensor],
                attention_mask: Optional[torch.Tensor] = None,
                compute_dtype: torch.dtype = torch.bfloat16,
                remat: bool = False) -> torch.Tensor:
        """Causal forward over [B, T] tokens → f32 logits [B, T, vocab]
        (JAX `forward` :223). `remat` recomputes each layer in the backward
        pass (`torch.utils.checkpoint`) instead of keeping its activations,
        as the JAX `jax.checkpoint` per layer does: the same loss and
        gradients for a second forward's operations."""
        config = self.config
        B, T = input_ids.shape
        device = input_ids.device
        h = self.embed_inputs(input_ids, class_ids, attr_ids, compute_dtype)
        cos_t, sin_t = _device_rotary_tables(config, device)
        cos, sin = cos_t[:T], sin_t[:T]

        mask = torch.ones((T, T), dtype=torch.bool, device=device).tril()[None, None]
        if attention_mask is not None:
            mask = mask & attention_mask[:, None, None, :].bool()
        bias = torch.where(mask, 0.0, -1e9).float()   # [B|1, 1, T, T]
        norm = float(np.sqrt(config.head_dim))

        def attend(q, k, v):
            # QK^T as an f32 GEMM of bf16-rounded values keeps the JAX
            # rounding (bf16 products, f32 sums); on the card, with TF32 off,
            # it runs on the FMA units, not the tensor cores (PERF.md §5).
            scores = torch.einsum(
                "bqhd,bkhd->bhqk",
                q.to(compute_dtype).float(), k.to(compute_dtype).float(),
            ) / norm
            probs = torch.softmax(scores + bias, dim=-1).to(compute_dtype)
            return torch.einsum("bhqk,bkhd->bqhd", probs, v)

        for layer in self.layers:
            def run(h, layer=layer):
                return layer_step(layer, layer.cast(compute_dtype), h, cos, sin,
                                  config, attend)
            h = checkpoint(run, h, use_reentrant=False) if remat else run(h)
        return self.head(h)


def loss_fn(model: EtudeDecoder, batch: Dict[str, torch.Tensor],
            compute_dtype: torch.dtype = torch.bfloat16,
            remat: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean cross-entropy over labels != -100 from f32 logits (JAX
    `loss_fn` :300), with the label count and the accuracy. Batch keys:
    input_ids, class_ids, labels, attention_mask and {name}_bin_ids for each
    attribute."""
    attr_ids = {name: batch[f"{name}_bin_ids"] for name in ATTRIBUTE_ORDER}
    logits = model(batch["input_ids"], batch["class_ids"], attr_ids,
                   attention_mask=batch.get("attention_mask"),
                   compute_dtype=compute_dtype, remat=remat)
    labels = batch["labels"].long()
    valid = labels != -100
    safe_labels = torch.where(valid, labels, 0)
    logp = torch.log_softmax(logits, dim=-1)
    token_ll = logp.gather(-1, safe_labels[..., None])[..., 0]
    n_valid = valid.sum().clamp(min=1)
    loss = -(token_ll * valid).sum() / n_valid
    metrics = {
        "loss": loss,
        "n_tokens": n_valid,
        "accuracy": ((logits.argmax(-1) == labels) & valid).sum() / n_valid,
    }
    return loss, metrics


# --------------------------------------------------------------- KV cache
def init_cache(config: EtudeDecoderConfig, batch: int, length: Optional[int] = None,
               device=None) -> Dict[str, torch.Tensor]:
    """A zeroed bf16 KV cache, k and v each [L, B, H, length, D] (JAX
    `init_cache` :336 keeps [L, B, length, H, D]); `length` defaults to
    max_position_embeddings."""
    shape = (config.num_hidden_layers, batch, config.num_attention_heads,
             length or config.max_position_embeddings, config.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def forward_with_cache(
    model: EtudeDecoder,
    cache: Dict[str, torch.Tensor],
    input_ids: torch.Tensor,            # [B, S]
    class_ids: torch.Tensor,            # [B, S]
    attr_ids: Dict[str, torch.Tensor],  # each [B, S]
    write_pos: int,                     # cache slot of token 0
    positions: torch.Tensor,            # [B, S] logical positions (rotary)
    visible_from: torch.Tensor,         # [B] first visible cache slot
    layer_weights: Optional[List[Dict[str, torch.Tensor]]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """S new tokens against the cache (JAX `forward_with_cache` :355), in
    bf16 with f32 rotary, LayerNorm and LM head. Their K/V are written in
    place at slots [write_pos, write_pos + S); the query at slot p sees the
    slots visible_from[b] <= t <= p. Returns (f32 logits [B, S, V], cache).

    The prefill (S = the left-padded prompt) runs plain masked attention, as
    JAX computes it with einsums; an S = 1 step runs the decode-attention
    kernel on every layer (its plain version only for CPU tensors), with
    the visibility as a [B, C] f32 bias. `layer_weights` are the layers'
    matmul weights already cast to bf16 (`DecoderLayer.cast`)."""
    config = model.config
    B, S = input_ids.shape
    device = input_ids.device
    k_cache, v_cache = cache["k"], cache["v"]
    C = k_cache.shape[3]

    h = model.embed_inputs(input_ids, class_ids, attr_ids, torch.bfloat16)
    cos_t, sin_t = _device_rotary_tables(config, device)
    cos, sin = cos_t[positions], sin_t[positions]             # [B, S, rot]

    key_slots = torch.arange(C, device=device)[None, None, :]
    query_slots = (write_pos + torch.arange(S, device=device))[None, :, None]
    visible = (key_slots <= query_slots) & (key_slots >= visible_from[:, None, None])
    bias = torch.where(visible, 0.0, -1e9).float()[:, None]   # [B, 1, S, C]

    if layer_weights is None:
        layer_weights = [layer.cast(torch.bfloat16) for layer in model.layers]
    end = write_pos + S
    for l, layer in enumerate(model.layers):
        def attend(q, k, v, l=l):
            k_cache[l, :, :, write_pos:end] = k.bfloat16().transpose(1, 2)
            v_cache[l, :, :, write_pos:end] = v.bfloat16().transpose(1, 2)
            if S == 1:
                return decode_attention(q[:, 0], k_cache[l], v_cache[l],
                                        bias[:, 0, 0])[:, None]
            return masked_attention(q, k_cache[l], v_cache[l], bias)

        h = layer_step(layer, layer_weights[l], h, cos, sin, config, attend)
    return model.head(h), cache
