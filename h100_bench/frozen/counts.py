"""Operations and bytes, counted from shapes, and the card's published peaks.

Kept with the benchmark so that a change to the program cannot change the
yardstick: a kernel's bytes are what its inputs and outputs hold, read once
and written once, whatever the kernel reads again.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12        # one H100 SXM, dense bf16 (data sheet)
HBM_BYTES_PER_S = 3.35e12       # one H100 SXM (data sheet)


# ---- the decoder ---------------------------------------------------------
def decoder_token_flops(config: dict, context: int) -> int:
    """FLOPs of one token through the decoder at `context` visible keys: the
    matmuls of every layer (QKV, attention output, the two MLP matmuls), the
    scores and the context products over the keys, and the LM head."""
    H, I = config["hidden_size"], config["intermediate_size"]
    L, V = config["num_hidden_layers"], config["vocab_size"]
    per_layer = 2 * (H * 3 * H + H * H + 2 * H * I) + 2 * 2 * H * context
    return L * per_layer + 2 * H * V


def decode_attention_bytes(B: int, H: int, C: int, D: int) -> int:
    """K1 (single-query attention over a C-slot cache): K and V in bf16, q in
    f32, the [B, C] f32 visibility bias, the bf16 output."""
    return 2 * B * H * C * D * 2 + B * H * D * 4 + B * C * 4 + B * H * D * 2


# ---- the analysis models -------------------------------------------------
def dilated_attention_bytes(B: int, H: int, T: int, d: int, attn_len: int) -> int:
    """K2 (banded attention at one dilation): q, k, v and o in bf16, and the
    relative-position table in f32."""
    return 4 * B * H * T * d * 2 + H * d * attn_len * 4


def conv2d_flops(n: int, c_in: int, c_out: int, kh: int, kw: int, h_out: int,
                 w_out: int) -> int:
    return 2 * n * c_out * h_out * w_out * c_in * kh * kw


def linear_flops(rows: int, d_in: int, d_out: int) -> int:
    return 2 * rows * d_in * d_out


def attention_flops(batch_heads: int, queries: int, keys: int, head_dim: int) -> int:
    """Scores and context products of full attention."""
    return 2 * 2 * batch_heads * queries * keys * head_dim


def hft_flops(segments: int, frames: int = 512, bins: int = 256, hid: int = 256,
              ff: int = 512, notes: int = 88, heads: int = 4, enc_layers: int = 3,
              dec_layers: int = 3, time_layers: int = 3, channels: int = 4,
              kernel: int = 5, margin: int = 32, velocities: int = 128) -> int:
    """The hFT forward over `segments` segments: the window convolution and
    token embedding, the frequency encoder, the note queries' layers, the
    time encoder and both head sets."""
    rows_f, rows_n = segments * frames * bins, segments * frames * notes
    n_proc = 2 * margin + 1
    conv_out = n_proc - kernel + 1
    d = hid // heads
    total = 2 * rows_f * channels * conv_out * kernel + linear_flops(rows_f, channels * conv_out, hid)

    def block(rows, q_len, k_len, n_seq):          # post-LN layer: attention + MLP
        return (4 * linear_flops(rows, hid, hid)
                + attention_flops(n_seq * heads, q_len, k_len, d)
                + linear_flops(rows, hid, ff) + linear_flops(rows, ff, hid))

    total += enc_layers * block(rows_f, bins, bins, segments * frames)
    cross = (2 * linear_flops(rows_n, hid, hid) + 2 * linear_flops(rows_f, hid, hid)
             + attention_flops(segments * frames * heads, notes, bins, d))
    total += cross + linear_flops(rows_n, hid, ff) + linear_flops(rows_n, ff, hid)
    total += (dec_layers - 1) * (block(rows_n, notes, notes, segments * frames) + cross)
    total += time_layers * block(rows_n, frames, frames, segments * notes)
    total += 2 * linear_flops(rows_n, hid, 3 + velocities)
    return total


def separator_flops(frames: int, freq_bins: int = 1024, base: int = 24, depth: int = 5,
                    cap: int = 192, kernel: int = 5, stems: int = 5) -> int:
    """The separator U-Net over a [frames, freq_bins] magnitude map (each
    convolution emits twice its channels for the GLU)."""
    chans = [min(base * 2 ** i, cap) for i in range(depth)]
    mult = 2 ** depth
    t, f = -(-frames // mult) * mult, -(-freq_bins // mult) * mult
    total, ch, sizes = 0, 1, []
    for co in chans:
        sizes.append((t, f, ch))
        t, f = t // 2, f // 2
        total += conv2d_flops(1, ch, 2 * co, kernel, kernel, t, f)
        total += conv2d_flops(1, co, 2 * co, kernel, kernel, t, f)
        ch = co
    for i in reversed(range(depth)):
        t, f, skip = sizes[i]
        co = chans[i - 1] if i > 0 else base
        total += conv2d_flops(1, ch, 2 * ch, kernel, kernel, t, f)
        total += conv2d_flops(1, ch + skip, 2 * co, kernel, kernel, t, f)
        ch = co
    return total + conv2d_flops(1, ch, stems, kernel, kernel, t, f)


def beat_transformer_flops(frames: int, stems: int = 5, mel: int = 128, dmodel: int = 256,
                           heads: int = 8, hidden: int = 1024, layers: int = 9,
                           attn_len: int = 5, instr_layers: int = 3) -> int:
    """The Beat-Transformer over `frames` frames of every stem: the
    convolution front end, the dilated layers (q, k, v, the slot scores and
    the context, the MLP), the stem-attention layers and the heads."""
    n = stems
    w1 = mel - 2
    total = conv2d_flops(n, 1, 32, 5, 3, frames, w1)
    w2 = w1 // 3 - 11
    total += conv2d_flops(n, 32, 64, 1, 12, frames, w2)
    w3 = w2 // 3 - 5
    total += conv2d_flops(n, 64, dmodel, 3, 6, frames, w3)
    rows = n * frames
    d = dmodel // heads
    per_layer = (3 * linear_flops(rows, dmodel, dmodel)
                 + 2 * 2 * rows * heads * attn_len * d + 2 * rows * heads * attn_len * d
                 + linear_flops(rows, dmodel, hidden) + linear_flops(rows, hidden, dmodel))
    instr = (4 * linear_flops(rows, dmodel, dmodel)
             + attention_flops(frames * heads, stems, stems, d)
             + linear_flops(rows, dmodel, hidden) + linear_flops(rows, hidden, dmodel))
    return total + layers * per_layer + instr_layers * instr + linear_flops(frames, dmodel,
                                                                          2 + 300)
