"""Dilated sparse self-attention of the Beat-Transformer: a hand-written CUDA
kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel `dilated_attention_pallas`
(etude_tpu/ops/dilated_attention.py:276). Each query attends to 5 keys at
stride `dilation` (2^layer): 4 symmetric heads with offsets centred on the
query and 4 skewed heads shifted by -2/-1/+1/+2 strides, plus a learned
relative-position bias `er` per (head, slot). In the JAX package the kernel
is an alternate to the XLA shifted-slice form; in the port the CUDA kernel
(csrc/dilated_attention.cu) is the production path of all 9 layers of every
Beat-Transformer forward on the card.

Layout: q, k, v and the output are [B, H, T, d] with d contiguous, as in
the JAX functions; `er` is [H, d, attn_len].

Bound: the kernel must read q, k and v once and write o once,
4 * B*H*T*d * 2 bytes in bf16: 125.8 MB at B = 5 stems, H = 8, T = 12288,
d = 32, about 37.6 us at 3.35 TB/s. Design: a tile is 128 queries of one
head taken in the strided view (by residue mod the dilation, then by
position); a block stages a tile's q rows and the k and v rows its 5 slots
fall on (a class segment's queries + 4 rows each) in shared memory with
cp.async, two lanes per query read every slot from there, and persistent
blocks stage the next tile while they compute this one. Each k and v row
crosses from L2 about once instead of up to 5 times. The source says what
the design still leaves behind.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

# Per-head offset shifts (in strides): 4 symmetric + skewed {-2,-1,+1,+2}.
HEAD_SHIFTS = (0, 0, 0, 0, -2, -1, 1, 2)
HEAD_DIM = 32          # the kernel's d; the Beat-Transformer's 256 / 8 heads
ATTN_LEN = 5           # the kernel's slots per query


def head_offsets(n_heads: int, attn_len: int) -> np.ndarray:
    """[n_heads, attn_len] slot offsets in units of the dilation stride."""
    shifts = HEAD_SHIFTS if n_heads == len(HEAD_SHIFTS) else [0] * n_heads
    half = attn_len // 2
    return np.stack([np.arange(attn_len) + s - half for s in shifts]).astype(np.int32)


def _head7_keys(k: torch.Tensor, head7_bug: bool) -> torch.Tensor:
    """k with head 7 replaced by head 6 (the reference's training bug,
    dilated_transformer_layer.py:52), for 8-head inputs when asked."""
    if head7_bug and k.shape[1] == 8:
        return torch.cat([k[:, :7], k[:, 6:7]], dim=1)
    return k


def dilated_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            er: torch.Tensor, dilation: int,
                            head7_bug: bool = False) -> torch.Tensor:
    """The kernel's arithmetic in eager PyTorch, in the shifted-slice form of
    the JAX `dilated_attention` (:106): every slot's keys are a static
    shifted slice of the zero-padded k. All sums, the softmax and the output
    accumulation are f32; the result is rounded once to q's dtype."""
    k = _head7_keys(k, head7_bug)
    B, H, T, d = q.shape
    A = er.shape[-1]
    offsets = head_offsets(H, A)
    pad = int(np.abs(offsets).max()) * dilation
    qf = q.float()
    kp = F.pad(k.float(), (0, 0, pad, pad))
    vp = F.pad(v.float(), (0, 0, pad, pad))

    def slot(src, a):   # [B, H, T, d]: every head's slot-a rows
        return torch.stack([
            src[:, h, pad + int(offsets[h, a]) * dilation:
                pad + int(offsets[h, a]) * dilation + T]
            for h in range(H)], dim=1)

    scores = torch.stack([(qf * slot(kp, a)).sum(-1) for a in range(A)])  # [A,B,H,T]
    rel = torch.einsum("bhtd,hda->abht", qf, er.float())
    logits = (scores + rel) / math.sqrt(d)
    key_pos = np.arange(T)[None, None] + offsets.T[:, :, None] * dilation   # [A, H, T]
    valid = torch.from_numpy((key_pos >= 0) & (key_pos < T))[:, None].to(q.device)
    logits = logits.masked_fill(~valid, -math.inf)
    m = logits.max(dim=0, keepdim=True).values
    e = torch.where(valid, torch.exp(logits - m.nan_to_num(neginf=0.0)), 0.0)
    denom = e.sum(dim=0, keepdim=True)
    probs = e / torch.where(denom > 0, denom, 1.0)   # a row with no valid slot → 0
    acc = sum(probs[a][..., None] * slot(vp, a) for a in range(A))
    return acc.to(q.dtype)


@functools.cache
def _launcher():
    fn = _build.load("dilated_attention").dilated_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_inputs(q, k, v, er):
    if q.dim() != 4 or er.dim() != 3:
        raise ValueError(f"expected q/k/v [B,H,T,d] and er [H,d,A]; got "
                         f"{tuple(q.shape)}, {tuple(er.shape)}")
    B, H, T, d = q.shape
    if d != HEAD_DIM or tuple(er.shape) != (H, d, ATTN_LEN):
        raise ValueError(f"the kernel takes d = {HEAD_DIM} and {ATTN_LEN} slots; "
                         f"got q {tuple(q.shape)}, er {tuple(er.shape)}")
    if H > len(HEAD_SHIFTS):
        raise ValueError(f"the kernel takes at most {len(HEAD_SHIFTS)} heads, got {H}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} differs from q {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name, t in (("k", k), ("v", v), ("er", er)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def dilated_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      er: torch.Tensor, dilation: int,
                      head7_bug: bool = False) -> torch.Tensor:
    """Returns the [B, H, T, d] attention output in q's dtype.

    CPU tensors take the plain version. CUDA tensors launch the kernel
    (q/k/v bf16 and contiguous, d = 32, 5 slots, at most 8 heads; er any
    float, used in f32) or raise; there is no fallback. Each launch adds one
    to `dilated_attention.launches`. head7_bug=True scores head 7 against
    head 6's keys (for checkpoints trained with the reference's bug).
    """
    tensors = (q, k, v, er)
    if all(t.device.type == "cpu" for t in tensors):
        return dilated_attention_plain(q, k, v, er, dilation, head7_bug)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("dilated_attention: tensors must all be on the CPU "
                         "or all on one CUDA device")
    _check_cuda_inputs(q, k, v, er)
    B, H, T, d = q.shape
    if dilation <= 0:
        raise ValueError(f"dilation must be positive, got {dilation}")
    er_t = er.float().transpose(1, 2).contiguous()        # [H, A, d] f32
    first = (ctypes.c_int * H)(*head_offsets(H, ATTN_LEN)[:, 0].tolist())
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), er_t.data_ptr(),
                     out.data_ptr(), B, H, T, d, ATTN_LEN, dilation,
                     int(head7_bug and H == 8), first, stream)
    if rc != 0:
        raise RuntimeError(f"dilated_attention kernel launch failed: CUDA error {rc}")
    dilated_attention.launches += 1
    return out


dilated_attention.launches = 0
