"""Inputs, limits, bounds and device timing for the hand kernels on the card,
shared by `chip_smoke.py` (kernels phase) and `etude_tpu_torch.tools.
kernel_ab` (one design against another in one process). Nothing here runs
on import; every function that touches the card needs CUDA."""

from __future__ import annotations

import math
import statistics
import time
from typing import Callable, Optional, Tuple

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_FLOP_PER_S = 67e12        # H100 SXM data sheet, CUDA cores
SLEEP_CYCLES_PER_S = 2e9      # above the H100's boost clock: a sleep at least this long


class L2Flush:
    """Called before each timed call: writes one 64 MB buffer, which
    replaces every line of the card's 50 MB L2, then reads another 64 MB,
    so the lines that the timed call evicts are clean, as on the main path,
    where the cache holds what earlier kernels read. With `dirty=True` it
    only writes (the flush of the timings before this one): the timed call
    then also pays for writing back up to 50 MB of the flush's lines."""

    def __init__(self, dirty: bool = False):
        self.dirty = dirty
        self.written = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
        self.read = None if dirty else torch.zeros(8 * 2**20, dtype=torch.int64, device="cuda")

    def __call__(self) -> None:
        self.written.zero_()
        if self.read is not None:
            self.read.sum()


def time_ms(fn: Callable[[], object], iters: int = 50,
            flush: Optional[Callable[[], None]] = None) -> float:
    """Median device time of one call: CUDA events around each call, after
    warm-up, with `flush()` before each (an `L2Flush`, so inputs come from
    HBM as on the main path). The calls queue behind a sleeping kernel long
    enough for the host to enqueue them all, so the events time the device
    and not the host's launch path (the Python wrapper's checks, ctypes)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ahead_s = min(0.5, iters * (2 * host_s + 1e-4))
    torch.cuda._sleep(int(SLEEP_CYCLES_PER_S * ahead_s))
    for s, e in zip(starts, ends):
        if flush is not None:
            flush()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def kernel_tolerance(ref: torch.Tensor) -> float:
    """max|kernel - plain| allowed: two bf16 ulps (2^(e-7) for 2^e <= |x|)
    of the largest |output|. The kernels sum in another order than their
    plain versions, which can flip a bf16 rounding of p or o; a masking,
    index or tail error moves o by far more."""
    top = ref.float().abs().max().item()
    return 2 * 2.0 ** (math.floor(math.log2(top)) - 7)


def bound(n_bytes: float, n_ops: float) -> Tuple[float, str]:
    """The least time the card could take: (ms, "bytes" or "operations")."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_FLOP_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def attention_inputs(B: int, C: int, seed: int, H: int = 8, D: int = 64):
    """K1's inputs, made on the card from a seed: q f32, k/v bf16, bias
    f32. Visibility is random (70%); the first stream's second half is
    hidden and, when B > 1, the last stream's whole row."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, H, D, device="cuda", generator=g)
    k = torch.randn(B, H, C, D, device="cuda", generator=g).bfloat16()
    v = torch.randn(B, H, C, D, device="cuda", generator=g).bfloat16()
    visible = torch.rand(B, C, device="cuda", generator=g) < 0.7
    visible[0, C // 2:] = False
    if B > 1:
        visible[-1] = False
    bias = torch.where(visible, 0.0, -1e9).float()
    return q, k, v, bias


def decode_bound(B: int, H: int, C: int, D: int) -> Tuple[float, str, int]:
    """K1: K and V read once, q, bias read once, o written once; 4·C·D
    flops per (b, h) for the two products and about 5 per slot for the
    softmax."""
    n_bytes = 2 * B * H * C * D * 2 + B * H * D * 4 + B * C * 4 + B * H * D * 2
    ms, by = bound(n_bytes, 4 * B * H * C * D + 5 * B * H * C)
    return ms, by, n_bytes


def dilated_inputs(B: int, T: int, seed: int, H: int = 8, d: int = 32, attn_len: int = 5):
    """K2's inputs, made on the card from a seed: bf16 q, k, v [B, H, T, d]
    and er [H, d, attn_len]."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(B, H, T, d, device="cuda", generator=g).bfloat16()
               for _ in range(3))
    er = (0.5 * torch.randn(H, d, attn_len, device="cuda", generator=g)).bfloat16()
    return q, k, v, er


def dilated_bound(B: int, H: int, T: int, d: int, attn_len: int = 5) -> Tuple[float, str, int]:
    """K2: q, k, v read once and o written once (bf16), er once (f32); per
    (query, slot): q.k and q.er (4d), p.v (2d) and the softmax (about 8)."""
    n_bytes = 4 * B * H * T * d * 2 + H * d * attn_len * 4
    ms, by = bound(n_bytes, B * H * T * attn_len * (6 * d + 8))
    return ms, by, n_bytes


def dilated_backward_bound(B: int, H: int, T: int, d: int,
                           attn_len: int = 5) -> Tuple[float, str, int]:
    """K2b: q, k, v and dO read once and dq, dk and dv written once (bf16),
    er read once and der written once (f32); per (query, slot): q.k, q.er
    and dO.v (6d), dq's k + er term (4d), dk, dv and der (6d) and the
    softmax and its gradient (about 12). What a design adds (the halo rows
    it stages, der's per-block partials) is its own choice, not the
    function's, and is not counted here."""
    n_bytes = 7 * B * H * T * d * 2 + 2 * H * d * attn_len * 4
    ms, by = bound(n_bytes, B * H * T * attn_len * (16 * d + 12))
    return ms, by, n_bytes
