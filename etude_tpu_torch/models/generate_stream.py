"""Whole-song generation with a persistent sliding-window KV cache, in
PyTorch (JAX counterpart: etude_tpu/models/generate_stream.py; its module
docstring explains the stream, the window and the two documented ways it
differs from the per-bar rebuild engine).

Every bar's prompt is a contiguous suffix of one token stream

    [E,E,...,E] X_0 Y_0 X_1 Y_1 ... X_i Y_i ...
     n_ctx empty pairs (seeded once)

so per bar only the new condition tokens X_i are encoded against the cache,
and each decode step is one S = 1 chunk whose attention runs the hand-written
CUDA kernel (ops/decode_attention.py) on every layer.

Cache layout, a port decision: K/V are [L, B, H, C, D] with D contiguous, so
a slot row is 128 contiguous bytes (the JAX cache is [L, B, H, D, C], slot
axis last for the TPU's lanes). The slot axis has two regions:

    [0, hist)                  compacted history window: slot j of stream b
                               holds global position win_start[b] + j
    [hist, hist + X + 1 + max_new)
                               this bar's condition tokens, the Bar_BOS, then
                               one slot per decode step, at offsets SHARED by
                               all streams

`slot_pos` [B, C] holds the global position in each slot, -1 = dead. A key is
visible to a query at position q iff win_start[b] <= slot_pos <= q; parked
streams (past their Bar_EOS) and condition padding write -1.

Where JAX threads an immutable cache through a jitted while_loop, the port
updates the cache tensors in place (functions return the same dict) and runs
the bar and step loops on the host, with the per-step done flags on the
device and one host read of "all done" per step. The attention reads the full
slot axis; the JAX engine's `hist_read` narrowing only skips slots that are
always dead, so the results are the same.

`kv_quant` keeps K/V as int8 with one f32 scale per (layer, stream, head,
slot), amax/127 symmetric (JAX `init_stream_cache(quant=True)` :130-160):
half the cache bytes. JAX computes its attention with XLA einsums, int8 x
int8 → s32 with the scales applied outside the contractions, and so does
the port, in plain PyTorch with exact products: the score sums (D = 64
terms of at most 127², below 2^24) in f32, the context sums (C terms, which
can pass 2^24) in f64. The int8 path launches no kernel; the bf16 path runs
the decode-attention kernel on every S = 1 step.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.tokenizer import SRC_CLASS_ID, TGT_CLASS_ID
from ..ops.decode_attention import decode_attention
from ..ops.sampling import sample_token
from ..utils.logger import logger
from .decoder import (ATTRIBUTE_ORDER, EtudeDecoder, EtudeDecoderConfig, layer_step,
                      masked_attention)
from .generate import ATTR_KEYS, _ATTR_KEY_TO_NAME

_POS_SPLIT = 4096  # positions = hi * 4096 + lo; hi phases folded mod 2π


@functools.lru_cache(maxsize=8)
def _phase_tables(rotary_dim: int, rotary_base: float, max_hi: int):
    """(hi_phase [max_hi, rot/2] f32 folded mod 2π in f64, inv_freq [rot/2]
    f32), as numpy arrays."""
    inv_freq = 1.0 / (
        rotary_base ** (np.arange(0, rotary_dim, 2, dtype=np.float64) / rotary_dim)
    )
    hi = np.arange(max_hi, dtype=np.float64)[:, None] * _POS_SPLIT * inv_freq[None]
    hi_phase = np.mod(hi, 2 * np.pi).astype(np.float32)
    return hi_phase, inv_freq.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _device_phase_tables(rotary_dim: int, rotary_base: float, max_hi: int,
                         device: torch.device):
    hi_phase, inv_freq = _phase_tables(rotary_dim, rotary_base, max_hi)
    return torch.from_numpy(hi_phase).to(device), torch.from_numpy(inv_freq).to(device)


def _rotary_at(positions: torch.Tensor, config: EtudeDecoderConfig, max_hi: int):
    """cos/sin [..., rotary_dim] at arbitrary (large) integer positions."""
    hi_phase, inv_freq = _device_phase_tables(
        config.rotary_dim, config.rotary_base, max_hi, positions.device
    )
    hi = torch.div(positions, _POS_SPLIT, rounding_mode="floor")
    lo = (positions % _POS_SPLIT).float()
    phase = hi_phase[hi] + lo[..., None] * inv_freq
    emb = torch.cat([phase, phase], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def init_stream_cache(config: EtudeDecoderConfig, batch: int, cache_len: int,
                      device=None, quant: bool = False):
    """Two-region window cache: k/v [L, B, H, C, D] (bf16, or int8 with
    `quant` and then f32 scales k_scale/v_scale [L, B, H, C]), slot_pos
    [B, C] = -1."""
    L, H, D = (config.num_hidden_layers, config.num_attention_heads,
               config.head_dim)
    shape = (L, batch, H, cache_len, D)
    dtype = torch.int8 if quant else torch.bfloat16
    cache = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "slot_pos": torch.full((batch, cache_len), -1, dtype=torch.long,
                               device=device),
    }
    if quant:
        cache["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        cache["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
    return cache


def _quantize_kv(x: torch.Tensor):
    """[..., D] f32 → (int8 values, f32 scales [...]): amax/127 symmetric
    per row (JAX `_quantize_kv` :163, bit for bit)."""
    scale = x.abs().amax(dim=-1) / 127.0
    q = torch.round(x / scale.clamp_min(1e-8)[..., None])
    return q.to(torch.int8), scale


def compact_window(cache, win_start: torch.Tensor, cur: torch.Tensor, hist: int):
    """Gather each stream's live window [win_start, cur) to the front of the
    history region and clear the bar region, in place.

    A plain gather replaces the JAX package's one-hot matmul (a TPU
    workaround). A target position with no source slot (dropped by an
    earlier, further-forward truncation: the window start regressed) stays
    dead, so no zero-K/V phantom key is ever exposed."""
    slot_pos = cache["slot_pos"]
    B, C = slot_pos.shape
    j = torch.arange(hist, device=slot_pos.device)
    target_pos = win_start[:, None] + j[None]                       # [B, hist]
    live = target_pos < cur[:, None]
    match = (slot_pos[:, None, :] == target_pos[:, :, None]) & live[:, :, None]
    live = live & match.any(dim=2)
    src = match.int().argmax(dim=2)                                 # [B, hist]

    for key in ("k", "v", "k_scale", "v_scale"):
        if key not in cache:
            continue
        arr = cache[key]                                # [L,B,H,C,D] or [L,B,H,C]
        L, _, H = arr.shape[:3]
        tail = arr.shape[4:]
        index = src.view(1, B, 1, hist, *[1] * len(tail)).expand(L, B, H, hist, *tail)
        hist_part = torch.gather(arr, 3, index)
        hist_part = torch.where(live.view(1, B, 1, hist, *[1] * len(tail)), hist_part,
                                torch.zeros((), dtype=arr.dtype, device=arr.device))
        arr[:, :, :, :hist] = hist_part
        arr[:, :, :, hist:] = 0
    slot_pos[:, :hist] = torch.where(live, target_pos, -1)
    slot_pos[:, hist:] = -1
    return cache


def _quant_attention(q, k_l, v_l, ks_l, vs_l, bias):
    """Attention over the int8 cache, as the JAX quant path computes it
    (generate_stream.py:398-419): q quantized per (token, head), scores
    int8·int8 scaled by the q and key-slot scales, f32 softmax; the
    probabilities times the value-slot scales quantized per (stream, head,
    query) and contracted with the int8 values. q [B, S, H, D] f32;
    k_l/v_l [B, H, C, D] int8; ks_l/vs_l [B, H, C] f32; bias [B, 1, S, C] →
    context [B, S, H, D] bf16."""
    q_q, q_s = _quantize_kv(q)
    s32 = torch.einsum("bqhd,bhcd->bhqc", q_q.float(), k_l.float())
    scores = (s32 * q_s.transpose(1, 2)[..., None] * ks_l[:, :, None, :]
              ) / math.sqrt(q.shape[-1])
    probs = torch.softmax(scores + bias, dim=-1)
    pv = probs * vs_l[:, :, None, :]
    p_scale = pv.amax(dim=-1) / 127.0
    p_q = torch.round(pv / p_scale.clamp_min(1e-12)[..., None])
    c32 = torch.einsum("bhqc,bhcd->bqhd", p_q.double(), v_l.double())
    return (c32.float() * p_scale.transpose(1, 2)[..., None]).bfloat16()


def stream_chunk(
    model: EtudeDecoder,
    cache,
    input_ids: torch.Tensor,           # [B, S]
    class_ids: torch.Tensor,           # [B, S]
    attr_ids: Dict[str, torch.Tensor],
    start_pos: torch.Tensor,           # [B] global position of token 0
    win_start: torch.Tensor,           # [B] first visible global position
    slot_offset: int,                  # tokens land in [slot_offset, +S)
    valid_len: Optional[torch.Tensor] = None,  # [B]: tokens s >= valid_len[b]
                                               # write slot_pos -1 (junk)
    max_hi: int = 16,
    embed_extra: Optional[torch.Tensor] = None,  # [B, S, hidden] class+attr
                                                 # embedding, hoisted per bar
    layer_weights: Optional[List[Dict[str, torch.Tensor]]] = None,
):
    """Encode S new tokens of the stream against the window cache, writing
    their K/V and positions in place. Returns (f32 logits [B, S, V], cache).

    On a bf16 cache, S = 1 runs the CUDA decode-attention kernel on every
    layer (its plain version on the CPU) and S > 1 (the seed and condition
    chunks) runs plain masked attention; an int8 cache runs
    `_quant_attention` for every S. Compute is bf16 (f32 rotary, LayerNorm
    and LM head).
    `layer_weights` are the layers' matmul weights already cast to bf16
    (EtudeDecoder layers' `cast`), made once per song."""
    config = model.config
    B, S = input_ids.shape
    device = input_ids.device

    if embed_extra is None:
        h = model.embed_inputs(input_ids, class_ids, attr_ids, torch.bfloat16)
    else:
        h = (model.word_emb(input_ids) + embed_extra).bfloat16()

    offsets = torch.arange(S, device=device)
    positions = start_pos[:, None] + offsets[None]                  # [B, S]
    cos, sin = _rotary_at(positions, config, max_hi)
    if valid_len is None:
        pos_vals = positions
    else:
        pos_vals = torch.where(offsets[None] < valid_len[:, None], positions, -1)
    slot_pos = cache["slot_pos"]
    slot_pos[:, slot_offset:slot_offset + S] = pos_vals

    # Visibility bias [B, 1, S, C], computed once and shared by all layers.
    key_pos = slot_pos[:, None, None, :]
    visible = (key_pos >= win_start[:, None, None, None]) & (
        key_pos <= positions[:, None, :, None]
    )
    bias = torch.where(visible, 0.0, -1e9).float()

    if layer_weights is None:
        layer_weights = [layer.cast(torch.bfloat16) for layer in model.layers]
    k_cache, v_cache = cache["k"], cache["v"]
    quant = "k_scale" in cache
    slots = slice(slot_offset, slot_offset + S)
    for l, layer in enumerate(model.layers):
        def attend(q, k, v, l=l):
            if quant:
                for arr, scale, x in ((k_cache, cache["k_scale"], k),
                                      (v_cache, cache["v_scale"], v.float())):
                    values, scales = _quantize_kv(x)
                    arr[l, :, :, slots] = values.transpose(1, 2)
                    scale[l, :, :, slots] = scales.transpose(1, 2)
                return _quant_attention(q, k_cache[l], v_cache[l], cache["k_scale"][l],
                                        cache["v_scale"][l], bias)
            k_cache[l, :, :, slots] = k.bfloat16().transpose(1, 2)
            v_cache[l, :, :, slots] = v.bfloat16().transpose(1, 2)
            if S == 1:
                ctx = decode_attention(q[:, 0], k_cache[l], v_cache[l], bias[:, 0, 0])
                return ctx[:, None]
            return masked_attention(q, k_cache[l], v_cache[l], bias)

        h = layer_step(layer, layer_weights[l], h, cos, sin, config, attend)
    return model.head(h), cache


@torch.no_grad()
def generate_song_stream(
    model: EtudeDecoder,
    x_tokens: torch.Tensor,            # [B, N_BARS, X] long, right-padded
    x_lens: torch.Tensor,              # [B, N_BARS] long
    x_attrs: Dict[str, torch.Tensor],  # each [B, N_BARS] long
    n_bars: int,
    max_output_tokens: int,
    generator: Optional[torch.Generator],
    temperature: float,
    top_p: float,
    *,
    n_ctx: int,
    max_new_tokens: int,
    hist: int,
    bar_bos_id: int,
    bar_eos_id: int,
    pad_id: int,
    prompt_cap: int,
    prompt_keep: int,
    max_hi: int,
    kv_quant: bool = False,
    stats: Optional[Dict[str, int]] = None,
):
    """Generate every bar of a song for B lockstep streams.

    Returns (y_tokens [B, N_BARS, max_new_tokens], y_counts [B, N_BARS]);
    each bar's tokens exclude the Bar_BOS opener and include the Bar_EOS.
    `kv_quant` keeps the cache in int8. `stats["single_token_chunks"]`,
    when given, counts the S = 1 chunks run (on a bf16 cache each launches
    the decode-attention kernel once per layer on a card)."""
    device = x_tokens.device
    B, N_BARS, X = x_tokens.shape
    cache_len = hist + X + 1 + max_new_tokens
    weights = [layer.cast(torch.bfloat16) for layer in model.layers]
    cache = init_stream_cache(model.config, B, cache_len, device=device, quant=kv_quant)
    chunk = functools.partial(stream_chunk, model, cache, max_hi=max_hi,
                              layer_weights=weights)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.long, device=device)

    # Seed: n_ctx empty (X, Y) pairs, straight into the history region.
    seed_len = 4 * n_ctx
    seed_ids = torch.tensor([bar_bos_id, bar_eos_id] * (2 * n_ctx),
                            device=device).repeat(B, 1)
    seed_cls = torch.tensor(([SRC_CLASS_ID] * 2 + [TGT_CLASS_ID] * 2) * n_ctx,
                            device=device).repeat(B, 1)
    seed_attrs = {name: full((B, seed_len), 1) for name in ATTRIBUTE_ORDER}
    zero = full((B,), 0)
    chunk(seed_ids, seed_cls, seed_attrs, start_pos=zero, win_start=zero,
          slot_offset=0)

    pair_starts = torch.tensor([4 * j for j in range(n_ctx + 1)],
                               device=device).repeat(B, 1)
    y_tokens = full((B, N_BARS, max_new_tokens), pad_id)
    y_counts = full((B, N_BARS), 0)
    cur = full((B,), seed_len)
    single = 0

    i = 0
    # The global budget: the bar that crosses it is kept, later ones dropped.
    while i < n_bars and bool((y_counts.sum(dim=1) < max_output_tokens).any()):
        x_i, len_i = x_tokens[:, i], x_lens[:, i]
        attrs_i = {name: a[:, i] for name, a in x_attrs.items()}

        # Window start: the last n_ctx pairs, tightened by the truncation
        # rule (prompt = window + X_i; past cap-1 keep the last prompt_keep).
        win_start = pair_starts[:, 0]
        x_end = cur + len_i
        win_start = torch.where(x_end - win_start > prompt_cap - 1,
                                x_end - prompt_keep, win_start)
        compact_window(cache, win_start, cur, hist)

        # The condition tokens: the bar's only multi-token chunk.
        chunk(x_i, full((B, X), SRC_CLASS_ID),
              {name: a[:, None].expand(B, X) for name, a in attrs_i.items()},
              start_pos=cur, win_start=win_start, slot_offset=hist,
              valid_len=len_i)

        # Bar_BOS opener (target class, target attrs) → first logits.
        cls1 = full((B, 1), TGT_CLASS_ID)
        attr1 = {name: a[:, None] for name, a in attrs_i.items()}
        logits, _ = chunk(full((B, 1), bar_bos_id), cls1, attr1,
                          start_pos=x_end, win_start=win_start,
                          slot_offset=hist + X)
        single += 1
        extra1 = model.embed_class_attrs(cls1, attr1)

        done = torch.zeros((B,), dtype=torch.bool, device=device)
        counts = full((B,), 0)
        bar_out = full((B, max_new_tokens), pad_id)
        step = 0
        while step < max_new_tokens and not bool(done.all()):
            tok = sample_token(logits[:, 0], generator, temperature, top_p)
            tok = torch.where(done, pad_id, tok)
            bar_out[:, step] = tok
            live = ~done
            counts += live.long()
            # Parked streams' positions do not advance; their slot gets
            # slot_pos -1 (valid_len 0), so the junk K/V is never visible.
            logits, _ = chunk(tok[:, None], cls1, attr1,
                              start_pos=x_end + 1 + step, win_start=win_start,
                              slot_offset=hist + X + 1 + step,
                              valid_len=live.long(), embed_extra=extra1)
            single += 1
            done = done | (tok == bar_eos_id)
            step += 1

        y_tokens[:, i] = bar_out
        y_counts[:, i] = counts
        cur = x_end + 1 + counts
        pair_starts = torch.cat([pair_starts[:, 1:], cur[:, None]], dim=1)
        i += 1

    if stats is not None:
        stats["single_token_chunks"] = stats.get("single_token_chunks", 0) + single
    return y_tokens, y_counts


def _round_up(n: int, multiple: int) -> int:
    return max(((n + multiple - 1) // multiple) * multiple, multiple)


class StreamingGenerationEngine:
    """Host wrapper: packs a song's condition bars once, runs the stream for
    every bar on the model's device, and unpacks bars.

    Prompt-window semantics (history pairs, empty-bar padding, truncation,
    attribute/class streams) are those of the JAX engine. `kv_quant` keeps
    the cache in int8 (JAX :690). `stats["single_token_chunks"]` accumulates
    the S = 1 chunks of every call.
    """

    def __init__(
        self,
        config: EtudeDecoderConfig,
        bar_bos_id: int,
        bar_eos_id: int,
        pad_id: int = 0,
        max_bar_token_limit: int = 512,
        x_len_buckets: Sequence[int] = (64, 128, 192, 320),
        bars_bucket: int = 32,
        kv_quant: bool = False,
    ):
        self.config = config
        self.kv_quant = kv_quant
        self.bar_bos_id = bar_bos_id
        self.bar_eos_id = bar_eos_id
        self.pad_id = pad_id
        self.max_bar_token_limit = min(
            max_bar_token_limit, config.max_position_embeddings
        )
        # The JAX engine's defaults (no prompt_cap override, context overlap
        # ratio 0.5): the prompt fills what a bar's tokens leave of the
        # position budget; past it, keep the last half of the positions.
        self.prompt_cap = max(
            config.max_position_embeddings - self.max_bar_token_limit, 1
        )
        keep = config.max_position_embeddings // 2 - 1
        self.prompt_keep = max(min(keep, self.prompt_cap - 1), 1)
        self.x_len_buckets = sorted(x_len_buckets)
        self.bars_bucket = bars_bucket
        self.stats = {"single_token_chunks": 0}

    def generate(self, model, all_x_bars, target_attributes_per_bar, **kw):
        return self.generate_batch(
            model, [all_x_bars], [target_attributes_per_bar], **kw
        )[0]

    def pack(self, x_bars_per_stream: List[List[List[int]]],
             attrs_per_stream: List[List[Dict[str, int]]]) -> Dict:
        """Right-padded condition arrays and the static sizes of the run:
        X (condition bucket), N_BARS, hist, max_hi and cache_len."""
        B = len(x_bars_per_stream)
        num_bars = max(len(s) for s in x_bars_per_stream)
        n_ctx = self.config.context_num_past_xy_pairs
        max_x = max((len(bar) for s in x_bars_per_stream for bar in s), default=2)
        # Bars longer than the prompt budget would be cut by the window rule
        # anyway; cap the buffer at the prompt cap.
        max_x = min(max_x, self.prompt_cap)
        X = next((b for b in self.x_len_buckets if max_x <= b),
                 _round_up(max_x, 64))
        N_BARS = _round_up(num_bars, self.bars_bucket)

        x_tokens = np.full((B, N_BARS, X), self.pad_id, np.int64)
        x_lens = np.zeros((B, N_BARS), np.int64)
        x_attrs = {name: np.ones((B, N_BARS), np.int64) for name in ATTRIBUTE_ORDER}
        empty_bar = [self.bar_bos_id, self.bar_eos_id]
        for b in range(B):
            stream = x_bars_per_stream[b]
            for i in range(N_BARS):
                bar = stream[i] if i < len(stream) else empty_bar
                bar = bar[-X:]  # over-long bars keep their tail (window rule)
                x_tokens[b, i, :len(bar)] = bar
                x_lens[b, i] = len(bar)
                attrs = (attrs_per_stream[b][i] if i < len(stream)
                         else {k: 1 for k in ATTR_KEYS})
                for key in ATTR_KEYS:
                    x_attrs[_ATTR_KEY_TO_NAME[key]][b, i] = attrs[key]

        # Stream length bound → rotary hi-table size; the compacted window
        # never exceeds prompt_cap positions (seeding adds 4·n_ctx).
        max_pos = 4 * n_ctx + N_BARS * (X + 1 + self.max_bar_token_limit)
        hist = max(self.prompt_cap, 4 * n_ctx)
        return {
            "x_tokens": x_tokens, "x_lens": x_lens, "x_attrs": x_attrs,
            "num_bars": num_bars, "X": X, "N_BARS": N_BARS, "hist": hist,
            "max_hi": int(max_pos // _POS_SPLIT) + 2,
            "cache_len": hist + X + 1 + self.max_bar_token_limit,
        }

    def generate_batch(
        self,
        model: EtudeDecoder,
        x_bars_per_stream: List[List[List[int]]],
        attrs_per_stream: List[List[Dict[str, int]]],
        *,
        temperature: float = 0.0,
        top_p: float = 0.9,
        max_output_tokens: int = 25600,
        seed: int = 0,
        progress: bool = False,
    ) -> List[List[List[int]]]:
        """One list of bars per stream; every bar starts with Bar_BOS."""
        if not x_bars_per_stream:
            return []
        packed = self.pack(x_bars_per_stream, attrs_per_stream)
        if packed["num_bars"] == 0:
            return [[] for _ in x_bars_per_stream]
        device = next(model.parameters()).device
        if progress:
            logger.info(
                f"streaming generation: {packed['num_bars']} bars, "
                f"{len(x_bars_per_stream)} stream(s) (buckets: X={packed['X']}, "
                f"bars={packed['N_BARS']}) on {device}"
            )
        generator = torch.Generator(device=device).manual_seed(seed)
        y_tokens, y_counts = generate_song_stream(
            model,
            torch.from_numpy(packed["x_tokens"]).to(device),
            torch.from_numpy(packed["x_lens"]).to(device),
            {k: torch.from_numpy(v).to(device) for k, v in packed["x_attrs"].items()},
            packed["num_bars"], max_output_tokens, generator,
            float(temperature), float(top_p),
            n_ctx=self.config.context_num_past_xy_pairs,
            max_new_tokens=self.max_bar_token_limit,
            hist=packed["hist"],
            bar_bos_id=self.bar_bos_id,
            bar_eos_id=self.bar_eos_id,
            pad_id=self.pad_id,
            prompt_cap=self.prompt_cap,
            prompt_keep=self.prompt_keep,
            max_hi=packed["max_hi"],
            kv_quant=self.kv_quant,
            stats=self.stats,
        )
        y_tokens = y_tokens.cpu().numpy()
        y_counts = y_counts.cpu().numpy()

        outputs: List[List[List[int]]] = [[] for _ in x_bars_per_stream]
        for b, stream in enumerate(x_bars_per_stream):
            total = 0
            for i in range(len(stream)):
                # The rebuild engine's budget rule: the bar that crosses
                # max_output_tokens is kept, later bars are dropped.
                if total >= max_output_tokens:
                    logger.warn(f"stream {b}: max_output_tokens reached at bar {i}")
                    break
                bar = [self.bar_bos_id] + y_tokens[b, i, :y_counts[b, i]].tolist()
                total += len(bar) - 1
                outputs[b].append(bar)
        return outputs
