"""Dynamic time warping for audio-to-audio alignment (JAX counterpart:
etude_tpu/ops/dtw.py).

Step set {(1,0), (0,1), (1,1)} with step weights {1.5, 1.5, 2.0} (the
reference's synctoolbox MrMsDTW settings); the raw optimal path is then made
strictly monotonic. Cost: alpha · (1 − chroma similarity) + (1 − alpha) ·
(1 − onset similarity).

The full DP (`_dtw_scan`) runs on the device as an anti-diagonal wavefront:
the cells of diagonal d depend only on diagonals d−1 and d−2, so each step is
vector work over one diagonal. The JAX package runs it as one `lax.scan`; the
port loops on the host over the N+M−2 diagonals with about a dozen eager
operations each, every diagonal staying on the device, and reads the uint8
traceback back once at the end. The path's walk is on the host.

The multi-resolution path (`mrms_dtw_path`) runs the full DP on features
downsampled 16x, then refines inside a band around the projected path at 4x
and 1x with the native banded DP (native/dtw_band.cc, built by g++ at first
use; a failed build raises, there is no fallback). `_dtw_band_numpy` is its
plain version, for the tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from . import _build

W_H = 1.5   # (0,1) horizontal (advance j)
W_V = 1.5   # (1,0) vertical (advance i)
W_D = 2.0   # (1,1) diagonal
_NEG = 1e30  # "infinity": f32, as the JAX package's sentinel


def _skew(x: torch.Tensor, fill) -> torch.Tensor:
    """[N, M] → [N+M−1, N] with out[d, i] = x[i, d−i], `fill` where d−i
    lies outside [0, M). The rows x[i] ++ [fill]*N, flattened and read back
    N+M−1 at a time, start i places later each: row i of the view holds
    x[i, j] at column i + j, the tail of row i−1's fill before it and its
    own fill after it."""
    N, M = x.shape
    padded = torch.cat([x, torch.full((N, N), fill, dtype=x.dtype, device=x.device)], dim=1)
    return padded.reshape(-1)[:N * (N + M - 1)].reshape(N, N + M - 1).T.contiguous()


def _dtw_scan(cost: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cost [N, M] f32 (on any device) → (the accumulated costs of the last
    diagonal [N], traceback codes [N+M−1, N] uint8), both on cost's device
    (JAX :31).

    Diagonal d holds cells (i, d−i); the row vector is indexed by i. Codes:
    0 = from (i, j−1), 1 = from (i−1, j), 2 = from (i−1, j−1); the first
    minimum wins in that order, as `jnp.argmin` picks it. Row 0 of the codes
    is zeros. Each diagonal's vector carries a leading `_NEG` slot, so that
    the predecessors (i−1) are views of the previous vectors."""
    cost = cost.to(torch.float32)
    N, M = cost.shape
    device = cost.device
    costs = _skew(cost, _NEG)
    valid = _skew(torch.ones_like(cost, dtype=torch.bool), False)
    neg = torch.tensor(_NEG, dtype=torch.float32, device=device)
    one = torch.tensor(1, dtype=torch.uint8, device=device)
    two = torch.tensor(2, dtype=torch.uint8, device=device)
    zero = torch.tensor(0, dtype=torch.uint8, device=device)

    codes = torch.zeros((N + M - 1, N), dtype=torch.uint8, device=device)
    prev2 = torch.full((N + 1,), _NEG, dtype=torch.float32, device=device)
    prev1 = prev2.clone()
    prev1[1] = cost[0, 0]
    for d in range(1, N + M - 1):
        c = costs[d]
        step = W_H * c                       # W_V = W_H: one product serves both
        from_h = prev1[1:] + step            # (0,1): same i on d−1
        from_v = prev1[:-1] + step           # (1,0): i−1 on d−1
        from_d = prev2[:-1] + W_D * c        # (1,1): i−1 on d−2
        best_hv = torch.minimum(from_h, from_v)
        diag = from_d < best_hv
        torch.where(diag, two, torch.where(from_v < from_h, one, zero), out=codes[d])
        # Diagonal d−2 is read: its buffer (slot 0 still _NEG) takes d.
        torch.where(valid[d], torch.minimum(best_hv, from_d), neg, out=prev2[1:])
        prev2, prev1 = prev1, prev2
    return prev1[1:], codes


def make_path_strictly_monotonic(path: np.ndarray) -> np.ndarray:
    """Drop points so both coordinate rows strictly increase (keeps the last
    point of every horizontal/vertical run plus the endpoints)."""
    i, j = path
    keep = [0]
    for k in range(1, path.shape[1]):
        if i[k] > i[keep[-1]] and j[k] > j[keep[-1]]:
            keep.append(k)
        else:
            # Replace the previous anchor if this point strictly dominates the
            # one before it (end of a flat run).
            if len(keep) >= 2 and i[k] > i[keep[-2]] and j[k] > j[keep[-2]]:
                keep[-1] = k
    if keep[-1] != path.shape[1] - 1:
        keep.append(path.shape[1] - 1)
    return path[:, keep]


def _walk_codes(codes: np.ndarray, N: int, M: int) -> np.ndarray:
    """Traceback through the wavefront's codes → path [2, L] from (0, 0)
    to (N−1, M−1)."""
    i, j = N - 1, M - 1
    path = [(i, j)]
    while i > 0 or j > 0:
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        else:
            code = int(codes[i + j, i])
            if code == 0:
                j -= 1
            elif code == 1:
                i -= 1
            else:
                i -= 1
                j -= 1
        path.append((i, j))
    path.reverse()
    return np.asarray(path, dtype=np.int64).T


def dtw_cost(feat_a_chroma, feat_a_onset, feat_b_chroma, feat_b_onset,
             alpha: float = 0.5, device=None) -> torch.Tensor:
    """The [N, M] f32 cost matrix of two feature pairs (numpy or tensors),
    on `device` (CUDA unless it is the CPU)."""
    device = resolve_device(device)

    def dev(x):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, np.float32))
        return x.to(device, torch.float32)

    a_c, a_o, b_c, b_o = (dev(x) for x in (feat_a_chroma, feat_a_onset,
                                           feat_b_chroma, feat_b_onset))
    chroma_cost = 1.0 - a_c @ b_c.T
    onset_cost = 1.0 - a_o @ b_o.T
    return alpha * chroma_cost + (1.0 - alpha) * onset_cost


def dtw_path(
    feat_a_chroma, feat_a_onset, feat_b_chroma, feat_b_onset,
    alpha: float = 0.5, device=None,
) -> np.ndarray:
    """Returns the warping path wp [2, L] with wp[0] = indices into a,
    wp[1] = indices into b (both strictly increasing) (JAX :87). The cost
    and the wavefront run on `device` (CUDA unless it is the CPU)."""
    cost = dtw_cost(feat_a_chroma, feat_a_onset, feat_b_chroma, feat_b_onset,
                    alpha, device)
    _, codes = _dtw_scan(cost)
    N, M = cost.shape
    return make_path_strictly_monotonic(_walk_codes(codes.cpu().numpy(), N, M))


# ===================================================== multi-resolution DTW
# MrMsDTW-style coarse-to-fine alignment: a full DTW at a heavily
# downsampled resolution anchors the path; each finer level refines it
# inside a diagonal band around the projected coarse path. Memory is
# O(N · band) instead of O(N · M): two 4-minute songs at 50 Hz are
# ~12k × 12k cells in full but ~12k × 129 banded.

def _smooth_downsample(
    chroma: np.ndarray, onset: np.ndarray, factor: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Average-pool features over time by `factor`; chroma re-ℓ2-normalized
    (synctoolbox smooths with a window then decimates — same effect)."""
    if factor == 1:
        return chroma, onset
    T = (chroma.shape[0] // factor) * factor
    c = chroma[:T].reshape(-1, factor, chroma.shape[1]).mean(axis=1)
    o = onset[:T].reshape(-1, factor, onset.shape[1]).mean(axis=1)
    c = c / np.maximum(np.linalg.norm(c, axis=1, keepdims=True), 1e-9)
    o = o / np.maximum(np.linalg.norm(o, axis=1, keepdims=True), 1e-9)
    return c.astype(np.float32), o.astype(np.float32)


def _band_centers_from_path(
    wp: np.ndarray, factor_prev: int, factor: int, n: int, m: int, w: int
) -> np.ndarray:
    """Project a coarse path onto the finer grid → monotone band centers."""
    scale = factor_prev / factor
    anchors_i = wp[0] * scale
    anchors_j = wp[1] * scale
    centers = np.interp(np.arange(n), anchors_i, anchors_j)
    centers = np.round(centers).astype(np.int64)
    centers = np.clip(centers, 0, m - 1)
    # The band must contain the matrix corners.
    centers[0] = min(centers[0], w)
    centers[-1] = max(centers[-1], m - 1 - w)
    return np.maximum.accumulate(centers)


def _banded_cost(
    a_chroma, a_onset, b_chroma, b_onset, centers, w, alpha
) -> np.ndarray:
    """[N, 2w+1] cost gathered along the band (O(N·w·d) work)."""
    N, M = a_chroma.shape[0], b_chroma.shape[0]
    offs = np.arange(-w, w + 1)
    cols = centers[:, None] + offs[None, :]          # [N, 2w+1]
    valid = (cols >= 0) & (cols < M)
    cols_c = np.clip(cols, 0, M - 1)
    bc = b_chroma[cols_c]                            # [N, 2w+1, d]
    bo = b_onset[cols_c]
    chroma_sim = np.einsum("nd,nkd->nk", a_chroma, bc)
    onset_sim = np.einsum("nd,nkd->nk", a_onset, bo)
    cost = alpha * (1.0 - chroma_sim) + (1.0 - alpha) * (1.0 - onset_sim)
    return np.where(valid, cost, 1e6).astype(np.float32)


def _dtw_band_numpy(cost_band, m, centers, weights=(W_H, W_V, W_D)):
    """The plain version of the native banded DP (same contract), for the
    tests: returns (codes [N, 2w+1] uint8, the accumulated cost at
    (N−1, M−1), +inf when unreachable)."""
    n, bw = cost_band.shape
    w = (bw - 1) // 2
    INF = np.inf
    codes = np.full((n, bw), 255, np.uint8)
    prev = np.full(bw, INF)
    c0 = centers[0]
    for k in range(bw):
        j = c0 + k - w
        if j < 0 or j >= m:
            continue
        if j == 0:
            prev[k] = cost_band[0, k]
        elif k > 0 and prev[k - 1] < INF:
            prev[k] = prev[k - 1] + weights[0] * cost_band[0, k]
            codes[0, k] = 0
    for i in range(1, n):
        dc = int(centers[i] - centers[i - 1])
        curr = np.full(bw, INF)
        row = cost_band[i]
        for k in range(bw):
            j = centers[i] + k - w
            if j < 0 or j >= m:
                continue
            c = row[k]
            best, code = INF, 255
            kv = k + dc
            if 0 <= kv < bw and prev[kv] < INF:
                v = prev[kv] + weights[1] * c
                if v < best:
                    best, code = v, 1
            kd = k + dc - 1
            if 0 <= kd < bw and prev[kd] < INF:
                v = prev[kd] + weights[2] * c
                if v < best:
                    best, code = v, 2
            if k > 0 and curr[k - 1] < INF:
                v = curr[k - 1] + weights[0] * c
                if v < best:
                    best, code = v, 0
            curr[k] = best
            codes[i, k] = code
        prev = curr
    k_end = (m - 1) - int(centers[-1]) + w
    final = prev[k_end] if 0 <= k_end < bw else INF
    return codes, float(final)


@functools.cache
def _band_library() -> ctypes.CDLL:
    lib = _build.load("dtw_band")
    lib.dtw_band.restype = ctypes.c_double
    lib.dtw_band.argtypes = [
        ctypes.c_void_p,                                  # cost_band [N, 2w+1] f32
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,   # N, M, w
        ctypes.c_void_p,                                  # centers [N] int64
        ctypes.c_float, ctypes.c_float, ctypes.c_float,   # step weights
        ctypes.c_void_p,                                  # out codes [N, 2w+1] uint8
    ]
    return lib


def dtw_band_native(cost_band: np.ndarray, m: int, centers: np.ndarray,
                    weights=(W_H, W_V, W_D)) -> Tuple[np.ndarray, float]:
    """Returns (codes [N, 2w+1] uint8, final cost) via the native DP."""
    cost_band = np.ascontiguousarray(cost_band, np.float32)
    centers = np.ascontiguousarray(centers, np.int64)
    n, bw = cost_band.shape
    codes = np.empty((n, bw), np.uint8)
    final = _band_library().dtw_band(
        cost_band.ctypes.data, n, m, (bw - 1) // 2, centers.ctypes.data,
        *weights, codes.ctypes.data)
    return codes, float(final)


def _walk_band_codes(codes, centers, w, n, m) -> np.ndarray:
    """Traceback through banded codes → path [2, L] from (0,0) to (n-1,m-1)."""
    i, j = n - 1, m - 1
    path = [(i, j)]
    while i > 0 or j > 0:
        k = j - int(centers[i]) + w
        code = int(codes[i, k]) if 0 <= k < codes.shape[1] else 255
        if code == 0:
            j -= 1
        elif code == 1:
            i -= 1
        elif code == 2:
            i -= 1
            j -= 1
        else:
            # Unreachable cell (should not happen with corner-anchored
            # centers); fall back to a diagonal step toward the origin.
            i, j = max(i - 1, 0), max(j - 1, 0)
        path.append((i, j))
    path.reverse()
    return np.asarray(path, np.int64).T


def dtw_path_banded(
    a_chroma, a_onset, b_chroma, b_onset,
    centers: np.ndarray, band: int, alpha: float = 0.5,
) -> np.ndarray:
    """Banded DTW around monotone `centers` (band half-width `band`), on the
    host through the native DP (JAX :257)."""
    cost_band = _banded_cost(
        a_chroma, a_onset, b_chroma, b_onset, centers, band, alpha
    )
    M = b_chroma.shape[0]
    codes, final = dtw_band_native(cost_band, M, centers)
    if not np.isfinite(final):
        raise RuntimeError("banded DTW found no path (band too narrow)")
    wp = _walk_band_codes(codes, centers, band, a_chroma.shape[0], M)
    return make_path_strictly_monotonic(wp)


def mrms_dtw_path(
    feat_a_chroma: np.ndarray, feat_a_onset: np.ndarray,
    feat_b_chroma: np.ndarray, feat_b_onset: np.ndarray,
    alpha: float = 0.5,
    levels: Tuple[int, ...] = (16, 4, 1),
    band: int = 64,
    device=None,
    timer=None,
) -> np.ndarray:
    """Coarse-to-fine DTW: the full wavefront DTW at 1/levels[0] resolution
    on `device`, then banded refinement at each finer level on the host
    (JAX :278). Path semantics match dtw_path. `timer` (a StageTimer) gets
    the spans "align: coarse wavefront" and "align: banded DP"."""
    from ..utils.profiling import maybe_span

    a_c = np.asarray(feat_a_chroma, np.float32)
    a_o = np.asarray(feat_a_onset, np.float32)
    b_c = np.asarray(feat_b_chroma, np.float32)
    b_o = np.asarray(feat_b_onset, np.float32)

    # Coarsest level: full DTW on the downsampled features.
    f0 = levels[0]
    with maybe_span(timer, "align: coarse wavefront"):
        ac, ao = _smooth_downsample(a_c, a_o, f0)
        bc, bo = _smooth_downsample(b_c, b_o, f0)
        wp = dtw_path(ac, ao, bc, bo, alpha=alpha, device=device)

    prev_factor = f0
    with maybe_span(timer, "align: banded DP"):
        for f in levels[1:]:
            ac, ao = _smooth_downsample(a_c, a_o, f)
            bc, bo = _smooth_downsample(b_c, b_o, f)
            n, m = ac.shape[0], bc.shape[0]
            centers = _band_centers_from_path(wp, prev_factor, f, n, m, band)
            wp = dtw_path_banded(ac, ao, bc, bo, centers, band, alpha=alpha)
            prev_factor = f
    return wp
