"""Mel filterbanks, the matmul DFT of the separation features and the
extractor's log-mel, on the device and in numpy (JAX counterpart:
etude_tpu/ops/mel.py).

The DFT is two f32 matmuls against cos/sin bases, as in the JAX package; it
lies outside any TPU kernel there and is a plain `torch.matmul` here. The
filterbank and the padding helpers are numpy.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device


def hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def hz_to_mel_slaney(f):
    """Slaney mel scale (librosa default): linear below 1 kHz, log above."""
    f = np.asarray(f, dtype=np.float64)
    mel = f / (200.0 / 3.0)
    log_region = f >= 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(log_region, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / logstep, mel)


def mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f = m * (200.0 / 3.0)
    logstep = np.log(6.4) / 27.0
    return np.where(m >= 15.0, 1000.0 * np.exp(logstep * (m - 15.0)), f)


def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    norm: str = "slaney",
    mel_scale: str = "htk",
) -> np.ndarray:
    """Triangular mel filterbank [n_fft//2 + 1, n_mels].

    mel_scale="htk" + norm="slaney" matches torchaudio's MelSpectrogram;
    mel_scale="slaney" matches librosa.filters.mel defaults (the separation
    features).
    """
    fmax = fmax if fmax is not None else sr / 2.0
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    if mel_scale == "htk":
        mel_pts = np.linspace(hz_to_mel_htk(fmin), hz_to_mel_htk(fmax), n_mels + 2)
        f_pts = mel_to_hz_htk(mel_pts)
    else:
        mel_pts = np.linspace(hz_to_mel_slaney(fmin), hz_to_mel_slaney(fmax), n_mels + 2)
        f_pts = mel_to_hz_slaney(mel_pts)

    slopes = f_pts[None, :] - freqs[:, None]  # [n_freqs, n_mels + 2]
    down = -slopes[:, :-2] / np.maximum(f_pts[1:-1] - f_pts[:-2], 1e-10)
    up = slopes[:, 2:] / np.maximum(f_pts[2:] - f_pts[1:-1], 1e-10)
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        fb *= (2.0 / (f_pts[2:] - f_pts[:-2]))[None, :]
    return fb.astype(np.float32)


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann (torch.hann_window default), f32."""
    n = np.arange(win_length)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))).astype(np.float32)


@functools.lru_cache(maxsize=4)
def dft_matrices(n_fft: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real-DFT bases [n_fft, n_fft//2+1] (cos, sin), f32, on `device`;
    built in f64 and rounded once, as the JAX package builds them."""
    angle = -2.0 * np.pi * np.outer(np.arange(n_fft), np.arange(n_fft // 2 + 1)) / n_fft
    return (torch.from_numpy(np.cos(angle).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(angle).astype(np.float32)).to(device))


def reflect_pad_host(wave: np.ndarray, pad: int) -> np.ndarray:
    """np.pad(mode='reflect') with a zero-pad fallback for signals shorter
    than the pad width (reflect requires pad <= len - 1)."""
    if len(wave) > pad:
        return np.pad(wave, pad, mode="reflect")
    return np.pad(wave, pad, mode="constant")


def frame_power_spectrum(frames: torch.Tensor, cos_m: torch.Tensor,
                         sin_m: torch.Tensor) -> torch.Tensor:
    """|rDFT(frames)|² via matmul DFT: [T, n_fft] → [T, n_fft//2+1]."""
    re = frames @ cos_m
    im = frames @ sin_m
    return re * re + im * im


@functools.lru_cache(maxsize=4)
def _mel_fb_device(sr: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: Optional[float], device: torch.device) -> torch.Tensor:
    return torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, fmin, fmax)).to(device)


def log_mel_spectrogram(
    wave: np.ndarray,
    *,
    sr: int = 16000,
    n_fft: int = 2048,
    hop: int = 256,
    win_length: int = 2048,
    n_mels: int = 256,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    log_offset: float = 1e-8,
    center: bool = True,
    device=None,
) -> torch.Tensor:
    """waveform [N] (host) → log-mel [n_frames, n_mels] f32 on `device`
    (JAX: `log_mel_spectrogram` :166, body `_log_mel_jit` :133).

    Reflect padding (`center`) is done on the host; framing, the Hann
    window, the f32 matmul DFT, the htk/slaney filterbank and
    `log(mel + log_offset)` on the device. The JAX package also zero-pads
    the wave to a multiple of 2048 frames so that song lengths share
    compiled programs, then trims; the frames it keeps are these, so the
    port does not pad. Runs on CUDA unless `device` is the CPU."""
    device = resolve_device(device)
    wave_np = np.asarray(wave, np.float32)
    n = len(wave_np)
    if center:
        wave_np = reflect_pad_host(wave_np, n_fft // 2)
        n_frames = n // hop + 1
    else:
        n_frames = 1 + max(n - n_fft, 0) // hop
    target_len = (n_frames - 1) * hop + n_fft
    wave_np = np.pad(wave_np, (0, max(0, target_len - len(wave_np))))[:target_len]

    window = hann_window(win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    cos_m, sin_m = dft_matrices(n_fft, device)
    frames = torch.from_numpy(wave_np).to(device).unfold(0, n_fft, hop)
    frames = frames * torch.from_numpy(window).to(device)
    power = frame_power_spectrum(frames, cos_m, sin_m)
    mel = power @ _mel_fb_device(sr, n_fft, n_mels, fmin, fmax, device)
    return torch.log(mel + log_offset)


def log_mel_spectrogram_host(
    wave: np.ndarray,
    *,
    sr: int = 16000,
    n_fft: int = 2048,
    hop: int = 256,
    win_length: int = 2048,
    n_mels: int = 256,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    log_offset: float = 1e-8,
    center: bool = True,
) -> np.ndarray:
    """`log_mel_spectrogram`'s semantics in numpy, [n_frames, n_mels] f32
    (JAX: `log_mel_spectrogram_host` :212): for building training batches
    on the host's worker threads, where a device mel per example would
    serialize them on the card."""
    wave_np = np.asarray(wave, np.float32)
    if center:
        wave_np = reflect_pad_host(wave_np, n_fft // 2)
    n_frames = 1 + max(len(wave_np) - n_fft, 0) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = wave_np[idx]

    window = hann_window(win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    spec = np.fft.rfft(frames * window[None, :], axis=-1)
    power = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    return np.log(power @ fb + log_offset)


def wav_to_logmel(wave: np.ndarray, feature_cfg, device=None) -> np.ndarray:
    """`log_mel_spectrogram` with an `ExtractorFeatureConfig`'s settings,
    back on the host (JAX: `wav_to_logmel` :249)."""
    return log_mel_spectrogram(
        wave, sr=feature_cfg.sr, n_fft=feature_cfg.fft_bins,
        hop=feature_cfg.hop_sample, win_length=feature_cfg.window_length,
        n_mels=feature_cfg.mel_bins, log_offset=feature_cfg.log_offset,
        device=device,
    ).cpu().numpy()
