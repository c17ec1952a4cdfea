"""Stage-2 part 1: source separation → beat-tracking features (JAX
counterpart: etude_tpu/data/separation.py).

On the device: STFT (n_fft 4096, hop 1024 at 44.1 kHz, a matmul DFT) → U-Net
ratio masks → per-stem masked power → 128-bin slaney mel (30–11000 Hz) →
dB (ref = per-stem max over the true frames, top_db 80). The features keep
the reference's (5, time, 128) contract, so beat detection reads them as
they are. The wave crosses to the device as int16 when it is exactly
PCM/32768 and is scaled back there.

The separator runs in bf16 on the card, as the JAX package's production
call does, and in f32 on the CPU (`utils/device.compute_dtype_for`).
`bypass=True` skips it: the mix's mel power goes into every stem slot (an
ablation of how much separation buys the beat tracker; JAX :92).
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from ..models.separator import Separator, SeparatorConfig
from ..ops.mel import (dft_matrices, frame_power_spectrum, hann_window,
                       mel_filterbank, reflect_pad_host)
from ..utils import model_loader
from ..utils.audio import decode_audio, resample_audio
from ..utils.device import compute_dtype_for, resolve_device
from ..utils.profiling import maybe_span
from ..weights import init_separator_params_np, separator_from_jax

SEP_SR = 44100
SEP_N_FFT = 4096
SEP_HOP = 1024
SEP_MELS = 128
SEP_FMIN = 30.0
SEP_FMAX = 11000.0
FRAME_BUCKET = 2048


def power_to_db_device(mel_power: torch.Tensor, true_frames: int) -> torch.Tensor:
    """librosa power_to_db(ref=per-stem max, top_db 80) on the device over
    [stems, T, mels]; frames at or past `true_frames` are left out of the
    per-stem max and the peak."""
    amin = 1e-10
    S = mel_power.clamp_min(0.0)
    frame_ok = (torch.arange(S.shape[1], device=S.device) < true_frames)[None, :, None]
    ref = torch.where(frame_ok, S, 0.0).amax(dim=(1, 2), keepdim=True).clamp_min(amin)
    log_spec = 10.0 * torch.log10(S.clamp_min(amin)) - 10.0 * torch.log10(ref)
    peak = torch.where(frame_ok, log_spec, -torch.inf).amax(dim=(1, 2), keepdim=True)
    return torch.maximum(log_spec, peak - 80.0)


@functools.lru_cache(maxsize=2)
def _sep_filterbank(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(mel_filterbank(
        SEP_SR, SEP_N_FFT, SEP_MELS, fmin=SEP_FMIN, fmax=SEP_FMAX,
        norm="slaney", mel_scale="slaney")).to(device)


def stft_power(wave: torch.Tensor) -> torch.Tensor:
    """wave [N] (host reflect-padded; f32, or int16 PCM scaled here exactly
    as the host's /32768) → Hann-windowed power spectrum [T, n_fft/2 + 1]."""
    if wave.dtype == torch.int16:
        wave = wave.float() / 32768.0
    cos_m, sin_m = dft_matrices(SEP_N_FFT, wave.device)
    window = torch.from_numpy(hann_window(SEP_N_FFT)).to(wave.device)
    frames = wave.unfold(0, SEP_N_FFT, SEP_HOP)                 # [T, n_fft] view
    return frame_power_spectrum(frames * window, cos_m, sin_m)


def separate_mel(model: Separator, wave: torch.Tensor, true_frames: int,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """wave [N] as `stft_power` takes it → per-stem mel power [stems, T, 128]
    f32.

    The mask net sees RMS-normalized log1p magnitudes (the RMS over the true
    frames only); the masks then apply to the un-normalized magnitudes."""
    device = wave.device
    mag = stft_power(wave).clamp_min(0.0).sqrt()

    n_frames = mag.shape[0]
    frame_ok = (torch.arange(n_frames, device=device) < true_frames)[:, None]
    n_true = max(min(true_frames, n_frames) * mag.shape[1], 1)
    rms = torch.sqrt(torch.where(frame_ok, mag, 0.0).square().sum() / n_true)
    mag_in = mag / rms.clamp_min(1e-6)

    masks = model(torch.log1p(mag_in)[None], compute_dtype)[0]   # [S, T, F]
    stem_power = (masks * mag[None]).square()
    return torch.einsum("stf,fm->stm", stem_power, _sep_filterbank(device))


def mix_mel(wave: torch.Tensor, n_stems: int) -> torch.Tensor:
    """Separator bypass (JAX `_mix_mel_jit` :92): the mix's mel power
    [n_stems, T, 128] f32, the same in every stem slot. `wave` as
    `stft_power` takes it."""
    mel = stft_power(wave) @ _sep_filterbank(wave.device)
    return mel[None].expand(n_stems, *mel.shape)


def pad_bucket_wave(wave: np.ndarray):
    """Host reflect-pad + frame-count bucketing for the separation STFT.

    Returns (padded [N] f32, true_frames). The reflect pad reproduces
    torch/librosa center semantics for the true frames; zero-padding to a
    FRAME_BUCKET multiple keeps the shapes few."""
    true_frames = 1 + len(wave) // SEP_HOP
    padded = reflect_pad_host(wave, SEP_N_FFT // 2)
    bucket_frames = int(np.ceil(true_frames / FRAME_BUCKET) * FRAME_BUCKET)
    target_len = (bucket_frames - 1) * SEP_HOP + SEP_N_FFT
    padded = np.pad(padded, (0, max(0, target_len - len(padded))))[:target_len]
    return padded, true_frames


def power_to_db(S: np.ndarray, top_db: float = 80.0, amin: float = 1e-10) -> np.ndarray:
    """librosa.power_to_db(ref=np.max) semantics per input array."""
    ref = max(float(S.max()), amin)
    log_spec = 10.0 * np.log10(np.maximum(amin, S))
    log_spec -= 10.0 * np.log10(ref)
    return np.maximum(log_spec, log_spec.max() - top_db)


class SourceSeparator:
    """Audio → (num_stems, time, 128) dB-mel features for beat tracking."""

    def __init__(
        self,
        model_path: Optional[Union[str, Path]] = None,
        params=None,
        config: Optional[SeparatorConfig] = None,
        device=None,
        allow_random_weights: bool = False,
        bypass: bool = False,
    ):
        """`params` (a JAX-layout numpy tree) wins over `model_path`. Runs on
        CUDA unless `device` is the CPU. `bypass` loads no weights and tiles
        the mix's mel into every stem slot."""
        self.config = config or SeparatorConfig()
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype_for(self.device)
        self.bypass = bypass
        self.model = None
        if bypass:
            return
        if params is None:
            params = model_loader.load_params(
                "separator", model_path,
                lambda seed: init_separator_params_np(self.config, seed),
                allow_random_weights)
        self.model = separator_from_jax(params, self.config, self.device)

    def separate_features(
        self,
        audio_path: Union[str, Path],
        output_npy_path: Optional[Union[str, Path]] = None,
        return_device: bool = False,
        timer=None,
        wave_sr=None,
    ):
        """Audio → dB-mel features (5, time, 128).

        `output_npy_path` also saves them there as f32 `.npy` (JAX
        :236-241), which `BeatDetector.detect` reads. return_device=True
        hands back the device tensor (the beat detector reads it there,
        with no host round trip). `wave_sr=(wave, native_sr)` reuses a
        decoded waveform; at 44.1 kHz it is not resampled, so WAV input
        still crosses as int16."""
        with maybe_span(timer, "sep: wav decode"):
            if wave_sr is not None:
                wave = resample_audio(wave_sr[0], wave_sr[1], SEP_SR)
            else:
                wave, _ = decode_audio(audio_path, target_sr=SEP_SR, mono=True)
            padded, true_frames = pad_bucket_wave(wave)
            # Ship int16 when the padded wave is exactly int16 PCM / 32768
            # (WAV input that was not resampled): the device rescale
            # reproduces the host conversion bit-exactly at half the bytes.
            scaled = padded * 32768.0
            as_i16 = scaled.astype(np.int16)
            if np.array_equal(as_i16.astype(np.float32), scaled):
                padded = as_i16
            wave_dev = torch.from_numpy(np.ascontiguousarray(padded)).to(self.device)

        with torch.inference_mode():
            with maybe_span(timer, "sep: STFT + U-Net + mel"):
                if self.bypass:
                    mel_power = mix_mel(wave_dev, self.config.num_stems)
                else:
                    mel_power = separate_mel(self.model, wave_dev, true_frames,
                                             self.compute_dtype)
            with maybe_span(timer, "sep: power to dB"):
                features = power_to_db_device(mel_power, true_frames)[:, :true_frames]

        if output_npy_path is not None:
            output_npy_path = Path(output_npy_path)
            output_npy_path.parent.mkdir(parents=True, exist_ok=True)
            np.save(output_npy_path, features.float().cpu().numpy())
        if return_device:
            return features
        return features.float().cpu().numpy()
