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

Gradient: on CUDA tensors the output comes from `_DilatedAttention`, whose
backward is the hand kernel K2b (csrc/dilated_attention_bwd.cu,
`dilated_attention_backward`): the gradient that jax.grad takes through the
JAX `dilated_attention` (:106), which the TPU kernel lacks. One launch: a
tile of 64 strided positions stages the k, v, q and dO rows around them
(`backward_tiles` mirrors its windows), recomputes p and ds in shared
memory and writes dq, dk and dv of its positions and a partial of der. On
CPU tensors autograd differentiates the plain version, which is also K2b's
oracle (`dilated_attention_backward_plain`).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import _build

# Per-head offset shifts (in strides): 4 symmetric + skewed {-2,-1,+1,+2}.
HEAD_SHIFTS = (0, 0, 0, 0, -2, -1, 1, 2)
HEAD_DIM = 32          # the kernel's d; the Beat-Transformer's 256 / 8 heads
ATTN_LEN = 5           # the kernel's slots per query
BWD_TILE = 64          # K2b's strided positions per tile (kTile in the source)


def head_offsets(n_heads: int, attn_len: int) -> np.ndarray:
    """[n_heads, attn_len] slot offsets in units of the dilation stride."""
    shifts = HEAD_SHIFTS if n_heads == len(HEAD_SHIFTS) else [0] * n_heads
    half = attn_len // 2
    return np.stack([np.arange(attn_len) + s - half for s in shifts]).astype(np.int32)


def strided_order(T: int, dilation: int) -> np.ndarray:
    """The strided view of K2 and K2b: the positions t of one (b, h) by
    residue mod the dilation, then by position; entry u is the position at
    strided index u. Within one residue class a query's 5 slots are its
    neighbours in u (class rows j + first + 0..4)."""
    return np.argsort(np.arange(T) % dilation, kind="stable")


@functools.lru_cache(maxsize=None)
def backward_tiles(T: int, dilation: int, first: int) -> np.ndarray:
    """K2b's partition of one (b, h), as the kernel computes it: one row per
    block, (u0, n, k_lo, k_hi, q_lo, q_hi) in strided indices. The block
    writes dq, dk and dv of the positions [u0, u0 + n) and der's partial over
    those queries; it stages the k and v rows [k_lo, k_hi) (its keys and its
    key rows' queries' keys: 4 rows each side) and the q and dO rows
    [q_lo, q_hi) (the queries reaching its key rows: u - first - 4 .. u -
    first), each window clipped to the class of the tile's first or last
    position. `first` is the head's slot-0 offset (-4..0)."""
    t = strided_order(T, dilation)
    j = t // dilation
    length = (T - t % dilation + dilation - 1) // dilation    # each position's class length
    u0 = np.arange(0, T, BWD_TILE)
    n = np.minimum(BWD_TILE, T - u0)
    head = j[u0]                                  # positions of the first class before u0
    tail = length[u0 + n - 1] - 1 - j[u0 + n - 1]  # positions of the last class after the tile
    halo = ATTN_LEN - 1
    tiles = np.stack([u0, n, u0 - np.minimum(halo, head), u0 + n + np.minimum(halo, tail),
                      u0 - np.minimum(head, first + halo), u0 + n + np.minimum(tail, -first)],
                     axis=1)
    tiles.flags.writeable = False
    return tiles


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




def dilated_attention_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                     er: torch.Tensor, grad_out: torch.Tensor,
                                     dilation: int, head7_bug: bool = False):
    """K2b's plain version: autograd of `dilated_attention_plain` in f32 from
    the same inputs. Returns (dq, dk, dv, der), f32, shaped as the inputs."""
    with torch.enable_grad():
        inputs = [t.detach().float().requires_grad_(True) for t in (q, k, v, er)]
        out = dilated_attention_plain(*inputs, dilation, head7_bug)
        return torch.autograd.grad(out, inputs, grad_out.float())


@functools.cache
def _launcher():
    fn = _build.load("dilated_attention").dilated_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _backward_launcher():
    fn = _build.load("dilated_attention_bwd").dilated_attention_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_inputs(q, k, v, er, dilation):
    if q.dim() != 4 or er.dim() != 3:
        raise ValueError(f"expected q/k/v [B,H,T,d] and er [H,d,A]; got "
                         f"{tuple(q.shape)}, {tuple(er.shape)}")
    B, H, T, d = q.shape
    if d != HEAD_DIM or tuple(er.shape) != (H, d, ATTN_LEN):
        raise ValueError(f"the kernel takes d = {HEAD_DIM} and {ATTN_LEN} slots; "
                         f"got q {tuple(q.shape)}, er {tuple(er.shape)}")
    if H > len(HEAD_SHIFTS):
        raise ValueError(f"the kernel takes at most {len(HEAD_SHIFTS)} heads, got {H}")
    if dilation <= 0:
        raise ValueError(f"dilation must be positive, got {dilation}")
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


def _first_offsets(H: int):
    return (ctypes.c_int * H)(*head_offsets(H, ATTN_LEN)[:, 0].tolist())


def _er_rows(er: torch.Tensor) -> torch.Tensor:
    return er.float().transpose(1, 2).contiguous()        # [H, A, d] f32


def _forward_kernel(q, k, v, er, dilation, head7_bug):
    """K2: one launch, counted in `dilated_attention.launches`."""
    _check_cuda_inputs(q, k, v, er, dilation)
    B, H, T, d = q.shape
    er_t = _er_rows(er)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):   # the launcher uses the current device
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), er_t.data_ptr(),
                         out.data_ptr(), B, H, T, d, ATTN_LEN, dilation,
                         int(head7_bug and H == 8), _first_offsets(H), stream)
    if rc != 0:
        raise RuntimeError(f"dilated_attention kernel launch failed: CUDA error {rc}")
    _build.count_launch(dilated_attention)
    return out


def dilated_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               er: torch.Tensor, grad_out: torch.Tensor,
                               dilation: int, head7_bug: bool = False):
    """K2b on CUDA tensors: (dq, dk, dv) in bf16 and der f32 [H, d, A], the
    gradient of `dilated_attention`'s output against `grad_out`. One launch
    (a block per `backward_tiles` row of each (b, h)) and a fixed-order sum
    of der's per-block partials; one call adds one to
    `dilated_attention_backward.launches`. Raises on what the kernel does
    not take, as the forward does."""
    if not all(t.is_cuda for t in (q, k, v, er, grad_out)):
        raise ValueError("dilated_attention_backward launches the CUDA kernel: every "
                         "tensor must be on one CUDA device (on the CPU, autograd "
                         "differentiates the plain version)")
    _check_cuda_inputs(q, k, v, er, dilation)
    if grad_out.shape != q.shape or grad_out.device != q.device:
        raise ValueError(f"grad_out {tuple(grad_out.shape)} on {grad_out.device} does not "
                         f"match q {tuple(q.shape)} on {q.device}")
    # dO arrives from a transpose's backward: contiguous bf16, 16-byte aligned.
    g = grad_out.to(torch.bfloat16).contiguous()
    if g.data_ptr() % 16:
        g = g.clone()
    B, H, T, d = q.shape
    # The kernel reads er as it comes, [H, d, A] in bf16 or f32.
    er_c = (er if er.dtype in (torch.bfloat16, torch.float32) else er.float()).contiguous()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    tiles = len(backward_tiles(T, dilation, int(head_offsets(H, ATTN_LEN)[0, 0])))
    part = torch.empty(H * ATTN_LEN * d, B * tiles, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):   # the launcher uses the current device
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _backward_launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), er_c.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), part.data_ptr(),
            B, H, T, d, ATTN_LEN, dilation, int(head7_bug and H == 8),
            int(er_c.dtype == torch.bfloat16), _first_offsets(H), stream)
    if rc != 0:
        raise RuntimeError(f"dilated_attention backward launch failed: CUDA error {rc}")
    _build.count_launch(dilated_attention_backward)
    der = part.sum(dim=1).view(H, ATTN_LEN, d).transpose(1, 2)   # [H, d, A]
    return dq, dk, dv, der


dilated_attention_backward.launches = 0


class _DilatedAttention(torch.autograd.Function):
    """K2 forward, K2b backward. Under torch.utils.checkpoint the forward
    runs again in the backward pass, and counts again."""

    @staticmethod
    def forward(ctx, q, k, v, er, dilation, head7_bug):
        ctx.save_for_backward(q, k, v, er)
        ctx.dilation, ctx.head7_bug = dilation, head7_bug
        return _forward_kernel(q, k, v, er, dilation, head7_bug)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        q, k, v, er = ctx.saved_tensors
        dq, dk, dv, der = dilated_attention_backward(q, k, v, er, grad_out,
                                                     ctx.dilation, ctx.head7_bug)
        # der is f32; the cast to er's type is the backward of the caller's cast.
        return dq, dk, dv, der.to(er.dtype), None, None


def dilated_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      er: torch.Tensor, dilation: int,
                      head7_bug: bool = False) -> torch.Tensor:
    """Returns the [B, H, T, d] attention output in q's dtype.

    CPU tensors take the plain version, which autograd differentiates. CUDA
    tensors launch the kernel (q/k/v bf16 and contiguous, d = 32, 5 slots,
    at most 8 heads; er any float, used in f32) or raise; there is no
    fallback. The output's backward is K2b. Each forward launch adds one to
    `dilated_attention.launches`. head7_bug=True scores head 7 against head
    6's keys (for checkpoints trained with the reference's bug); the key
    gradient then goes to head 6, as JAX's k.at[:, 7].set(k[:, 6]).
    """
    tensors = (q, k, v, er)
    if all(t.device.type == "cpu" for t in tensors):
        return dilated_attention_plain(q, k, v, er, dilation, head7_bug)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("dilated_attention: tensors must all be on the CPU "
                         "or all on one CUDA device")
    return _DilatedAttention.apply(q, k, v, er, dilation, head7_bug)


dilated_attention.launches = 0
