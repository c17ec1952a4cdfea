"""Chroma and chroma-onset features for audio-to-audio alignment (JAX
counterpart: etude_tpu/ops/chroma.py).

An STFT-based semitone filterbank (MIDI pitches 24–107, tuning-adjustable)
folded into 12 pitch classes, log-compressed and ℓ2-normalized; onset
features are per-chroma half-wave-rectified energy differences with an
exponential decay kernel. The features run on the device (`_chroma_core`):
the 4096-point f32 matmul DFT of ops/mel.py, the filterbank, the fold and
the onset filter, all in f32. The tuning estimate and the key-shift search
(`estimate_tuning`, `optimal_chroma_shift`) stay on the host in numpy, as
in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .mel import dft_matrices, frame_power_spectrum, hann_window, reflect_pad_host

ALIGN_SR = 22050
ALIGN_FEATURE_RATE = 50  # Hz
_N_FFT = 4096
_PITCH_LO, _PITCH_HI = 24, 108
_ONSET_DECAY = (0.9 ** np.arange(10)).astype(np.float32)


def _pitch_filterbank(sr: int, n_fft: int, tuning_cents: float = 0.0) -> np.ndarray:
    """[n_bins, n_pitches] triangular filters centered on MIDI pitches."""
    n_bins = n_fft // 2 + 1
    freqs = np.linspace(0, sr / 2, n_bins)
    pitches = np.arange(_PITCH_LO, _PITCH_HI)
    centers = 440.0 * 2 ** ((pitches - 69 + tuning_cents / 100.0) / 12.0)
    lo = centers * 2 ** (-0.5 / 12)
    hi = centers * 2 ** (0.5 / 12)
    up = (freqs[:, None] - lo[None]) / np.maximum(centers - lo, 1e-9)[None]
    down = (hi[None] - freqs[:, None]) / np.maximum(hi - centers, 1e-9)[None]
    fb = np.clip(np.minimum(up, down), 0.0, 1.0)
    # Normalize each filter to unit area so low pitches (few bins) keep weight.
    fb /= np.maximum(fb.sum(axis=0, keepdims=True), 1e-9)
    return fb.astype(np.float32)


def _unit_rows(x: torch.Tensor, floor: float) -> Tuple[torch.Tensor, torch.Tensor]:
    norm = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return x / torch.clamp(norm, min=floor), norm


def _chroma_core(padded: torch.Tensor, fb: torch.Tensor, hop: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reflect-padded wave [L] and pitch filterbank [bins, 84] on the device
    → (chroma [T, 12], onset [T, 12]), f32 (JAX :44)."""
    device = padded.device
    cos_m, sin_m = dft_matrices(_N_FFT, device)
    window = torch.from_numpy(hann_window(_N_FFT)).to(device)
    frames = padded.unfold(0, _N_FFT, hop) * window
    power = frame_power_spectrum(frames, cos_m, sin_m)      # [T, bins]
    n_frames = power.shape[0]
    chroma = (power @ fb).reshape(n_frames, -1, 12).sum(dim=1)
    chroma = torch.log1p(100.0 * chroma)
    chroma_n, _ = _unit_rows(chroma, 1e-6)

    # Onset features: half-wave rectified temporal difference per pitch class,
    # locally normalized, then the causal full convolution with the decay
    # kernel (jnp.convolve(x, decay)[:T]), out[t] = Σ_k decay[k]·x[t−k]:
    # written as shifted multiply-adds rather than a cuDNN convolution,
    # which may run in TF32.
    diff = torch.clamp(chroma[1:] - chroma[:-1], min=0.0)
    diff = torch.cat([torch.zeros(1, 12, device=device), diff])
    local = diff.amax(dim=1, keepdim=True)
    diff_n = diff / torch.clamp(local, min=1e-6) * torch.clamp(local, max=1.0)
    onset = torch.zeros_like(diff_n)
    for k, weight in enumerate(_ONSET_DECAY.tolist()):
        if k < n_frames:
            onset[k:] += weight * diff_n[:n_frames - k]
    onset, norm = _unit_rows(onset, 1e-6)
    return chroma_n, onset * (norm > 1e-3)


def chroma_features(
    wave: np.ndarray,
    sr: int = ALIGN_SR,
    feature_rate: int = ALIGN_FEATURE_RATE,
    tuning_cents: float = 0.0,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """waveform → (chroma [T, 12], onset [T, 12]) at feature_rate Hz, T =
    len(wave) // hop + 1 (JAX :80), as numpy. Runs on CUDA unless `device`
    is the CPU.

    The JAX package zero-pads the frame count to 2048-frame buckets so that
    song lengths share compiled programs, then trims; every feature of a
    frame depends only on that frame and earlier ones, so the port computes
    the true frames alone."""
    device = resolve_device(device)
    hop = sr // feature_rate
    n = len(wave)
    true_frames = n // hop + 1
    padded = reflect_pad_host(np.asarray(wave, np.float32), _N_FFT // 2)
    target_len = (true_frames - 1) * hop + _N_FFT
    padded = np.pad(padded, (0, max(0, target_len - len(padded))))[:target_len]
    fb = torch.from_numpy(_pitch_filterbank(sr, _N_FFT, tuning_cents)).to(device)
    chroma, onset = _chroma_core(torch.from_numpy(padded).to(device), fb, hop)
    return chroma.cpu().numpy(), onset.cpu().numpy()


def estimate_tuning(wave: np.ndarray, sr: int = ALIGN_SR) -> float:
    """Tuning deviation in cents via chroma energy over a ±50-cent sweep."""
    best, best_energy = 0.0, -1.0
    for cents in np.arange(-50, 50, 10.0):
        fb = _pitch_filterbank(sr, _N_FFT, cents)
        # Single coarse frame: average spectrum of the middle of the signal.
        mid = wave[len(wave) // 4: len(wave) // 4 + sr * 4]
        if len(mid) < _N_FFT:
            mid = np.pad(wave, (0, max(0, _N_FFT - len(wave))))
        spec = np.abs(np.fft.rfft(mid[:_N_FFT] * np.hanning(_N_FFT))) ** 2
        energy = float((spec @ fb).max())
        if energy > best_energy:
            best, best_energy = cents, energy
    return best


def _cens_like(chroma: np.ndarray, smooth: int = 21, down: int = 5
               ) -> np.ndarray:
    """Coarse CENS-style features: moving-average smoothing, downsampling,
    L2 normalization — the representation synctoolbox's shift search runs
    its per-shift DTWs on."""
    kernel = np.ones(smooth, np.float32) / smooth
    sm = np.stack([
        np.convolve(chroma[:, c], kernel, mode="same") for c in range(12)
    ], axis=1)
    sm = sm[::down]
    norm = np.linalg.norm(sm, axis=1, keepdims=True)
    return sm / np.maximum(norm, 1e-9)


def _dtw_cost_numpy(sim: np.ndarray) -> float:
    """Normalized DTW cost over a (1 − similarity) matrix with the MrMsDTW
    step set {(1,0), (0,1), (1,1)} and weights {1.5, 1.5, 2.0} — row-wise
    vectorized numpy DP (host-side; called 12 times by the shift search).

    The horizontal recurrence out[j] = min(base[j], out[j-1] + w·c[j]) is a
    min-plus prefix scan: with S = cumsum(w·c),
    out[j] = S[j] + cummin(base − S)[j] — exact and fully vectorized."""
    cost = (1.0 - sim).astype(np.float32)
    N, M = cost.shape
    INF = np.float32(1e30)

    S = np.cumsum(1.5 * cost[0])
    prev = cost[0, 0] + S - S[0]           # first row: horizontal chain only
    for i in range(1, N):
        steps_v = prev + 1.5 * cost[i]                    # from (i-1, j)
        steps_d = np.empty(M, np.float32)
        steps_d[0] = INF
        steps_d[1:] = prev[:-1] + 2.0 * cost[i, 1:]       # from (i-1, j-1)
        base = np.minimum(steps_v, steps_d)
        S = np.cumsum(1.5 * cost[i])
        prev = S + np.minimum.accumulate(base - S)
    return float(prev[-1]) / (N + M)


def optimal_chroma_shift(chroma_a: np.ndarray, chroma_b: np.ndarray) -> int:
    """Cyclic shift of b minimizing the coarse-CENS DTW cost against a —
    the synctoolbox compute_optimal_chroma_shift semantics. (A mean-chroma
    correlation is not robust: songs with flat pitch-class profiles can tie
    within noise and mis-key the whole alignment.)"""
    a = _cens_like(np.asarray(chroma_a, np.float32))
    b = _cens_like(np.asarray(chroma_b, np.float32))
    # Bound the per-shift DTW to ~600x600 for speed; the key decision is
    # global, so extra downsampling does not change the argmin.
    extra = max(int(np.ceil(max(a.shape[0], b.shape[0]) / 600)), 1)
    a, b = a[::extra], b[::extra]
    costs = []
    for s in range(12):
        sim = a @ np.roll(b, s, axis=1).T
        costs.append(_dtw_cost_numpy(sim))
    return int(np.argmin(costs))
