"""Single-query (S = 1) decode attention: a hand-written CUDA kernel and its
plain PyTorch version.

Replaces the Pallas TPU kernel `decode_attention_pallas`
(etude_tpu/ops/decode_attention.py:56). In the JAX package that kernel is an
alternate to the XLA einsums of `stream_chunk`; in the port the CUDA kernel
(csrc/decode_attention.cu) is the production path of every layer of every
S = 1 decode step.

Layout, a port decision: k and v are [B, H, C, D] with D contiguous (one slot
row is 128 contiguous bytes at D = 64), q is [B, H, D] and the visibility bias
is [B, C] f32. The JAX cache keeps the slot axis last ([.., D, C]) for the
TPU's lanes; the tests transpose when they feed the JAX kernel.

Bound: the kernel must read K and V once, 2 * B*H*C*D * 2 bytes (plus q, the
bias and the output); at B = 16, C = 1217 that is 39.9 MB per layer-step,
11.9 us at 3.35 TB/s. Design: one launch of a thread-block cluster of
`CLUSTER` blocks per (b, h), each streaming a contiguous chunk of
ceil(C / CLUSTER) K and then V rows through shared memory with cp.async,
and the softmax's max and sum exchanged over distributed shared memory, so
p is normalised by the global sum before its bf16 rounding, as on the TPU.
A block keeps its chunk's scores in shared memory: `max_cache_len()` slots
at most. The source says what the design still leaves behind.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

HEAD_DIM = 64          # the kernel's D; the decoder's published head width
CLUSTER = 4            # blocks per (b, h), each owning a chunk of the C slots
_THREADS = 256         # threads per block
_STAGES = 4            # 16-byte pieces each thread keeps in flight
_MAX_SMEM = 232_448    # bytes of shared memory one block may use on Hopper


def _fixed_smem_bytes() -> int:
    warps = _THREADS // 32
    return _STAGES * _THREADS * 16 + 4 * (warps * HEAD_DIM + 2 * CLUSTER + warps + HEAD_DIM)


def smem_bytes(C: int) -> int:
    """Dynamic shared memory of one block at C slots, as the kernel lays it
    out (decode_attention.cu `smem_bytes`): the threads' rings of loads and
    the chunk's scores (f32), then per-warp partial outputs, every rank's
    (max, sum), the reduction scratch and the received partials."""
    return _fixed_smem_bytes() + 4 * -(-C // CLUSTER)


def max_cache_len() -> int:
    """The largest C whose chunk of scores fits one block's shared memory."""
    return (_MAX_SMEM - _fixed_smem_bytes()) // 4 * CLUSTER


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in eager PyTorch: q [B, H, D] (any float),
    k, v [B, H, C, D] bf16, bias [B, C] f32 → o [B, H, D] bf16, with bf16
    rounding of q at entry, of p before PV and of o at exit."""
    D = q.shape[-1]
    qf = q.to(torch.bfloat16).float()
    s = torch.einsum("bhd,bhcd->bhc", qf, k.float()) * (1.0 / math.sqrt(D))
    p = torch.softmax(s + bias.float()[:, None, :], dim=-1)
    o = torch.einsum("bhc,bhcd->bhd", p.to(torch.bfloat16).float(), v.float())
    return o.to(torch.bfloat16)


@functools.cache
def _launcher():
    fn = _build.load("decode_attention").decode_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_inputs(q, k, v, bias):
    if q.dim() != 3 or k.dim() != 4 or bias.dim() != 2:
        raise ValueError(f"expected q [B,H,D], k/v [B,H,C,D], bias [B,C]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(bias.shape)}")
    B, H, C, D = k.shape
    if D != HEAD_DIM:
        raise ValueError(f"the kernel takes head_dim {HEAD_DIM}, got {D}")
    if tuple(q.shape) != (B, H, D) or tuple(v.shape) != (B, H, C, D) \
            or tuple(bias.shape) != (B, C):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, bias {tuple(bias.shape)}")
    for name, t, dtype in (("q", q, torch.float32), ("k", k, torch.bfloat16),
                           ("v", v, torch.bfloat16), ("bias", bias, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if smem_bytes(C) > _MAX_SMEM:
        raise ValueError(f"C = {C} slots exceed the cluster's shared memory "
                         f"(at most {max_cache_len()})")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """o [B, H, D] bf16 = softmax(bf16(q)·Kᵀ/√D + bias)·V per (b, h).

    CPU tensors take the plain version. CUDA tensors launch the kernel, one
    cluster launch of B*H*CLUSTER blocks (q f32, k/v bf16, bias f32, all
    contiguous, D = 64, C <= max_cache_len()), or raise; there is no
    fallback. The kernel runs on the tensors' device, whichever is current.
    Each launch adds one to `decode_attention.launches` (from any thread).
    """
    tensors = (q, k, v, bias)
    if all(t.device.type == "cpu" for t in tensors):
        return decode_attention_plain(q, k, v, bias)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("decode_attention: tensors must all be on the CPU "
                         "or all on one CUDA device")
    _check_cuda_inputs(q, k, v, bias)
    B, H, C, D = k.shape
    out = torch.empty((B, H, D), dtype=torch.bfloat16, device=q.device)
    # The launcher launches on the runtime's current device (and sets the
    # kernel's shared-memory attribute there): make it q's.
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                         out.data_ptr(), B, H, C, D, stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {rc}")
    _build.count_launch(decode_attention)
    return out


decode_attention.launches = 0
