"""Host-side audio I/O and the volume map (JAX counterpart:
etude_tpu/utils/audio.py).

WAV is read and written with scipy.io.wavfile; resampling evaluates scipy's
polyphase `resample_poly` filter in the port's native FIR
(`ops/resample.py`, `native/resample_fir.cc`), as the JAX package does.
Other containers go through ffmpeg where it is installed.
"""

from __future__ import annotations

import json
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
from scipy.io import wavfile

from ..ops.resample import resample_poly_native


def load_wav(path: Union[str, Path], target_sr: Optional[int] = None,
             mono: bool = True) -> Tuple[np.ndarray, int]:
    """Load a WAV file → (float32 waveform in [-1, 1], sample_rate).

    Integer PCM is scaled by its dtype range; optional mono mixdown and
    polyphase resampling to target_sr.
    """
    sr, data = wavfile.read(Path(path))
    if data.dtype == np.int16:
        wave = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wave = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wave = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wave = data.astype(np.float32)
    if mono and wave.ndim > 1:
        wave = wave.mean(axis=1)
    if target_sr is not None and target_sr != sr:
        wave = resample_audio(wave, sr, target_sr)
        sr = target_sr
    return wave, sr


def resample_audio(wave: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (scipy's Kaiser-windowed filter) in the native
    FIR, in f32; a library that does not build raises."""
    if orig_sr == target_sr:
        return wave
    g = np.gcd(int(orig_sr), int(target_sr))
    return resample_poly_native(wave, target_sr // g, orig_sr // g)


def save_wav(path: Union[str, Path], wave: np.ndarray, sr: int) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    clipped = np.clip(wave, -1.0, 1.0)
    wavfile.write(path, sr, (clipped * 32767.0).astype(np.int16))


def decode_audio(path: Union[str, Path], target_sr: Optional[int] = None,
                 mono: bool = True) -> Tuple[np.ndarray, int]:
    """Decode an audio file to a waveform: WAV natively, other formats
    through ffmpeg when it is installed (a clear error otherwise)."""
    path = Path(path)
    if path.suffix.lower() == ".wav":
        return load_wav(path, target_sr=target_sr, mono=mono)
    ffmpeg = shutil.which("ffmpeg")
    if not ffmpeg:
        raise RuntimeError(f"cannot decode {path.suffix} audio: ffmpeg not "
                           "available; provide WAV input")
    sr = target_sr or 44100
    cmd = [ffmpeg, "-v", "error", "-i", str(path), "-f", "f32le",
           "-acodec", "pcm_f32le", "-ac", "1" if mono else "2", "-ar", str(sr), "-"]
    raw = subprocess.run(cmd, capture_output=True, check=True).stdout
    wave = np.frombuffer(raw, dtype=np.float32)
    if not mono:
        wave = wave.reshape(-1, 2)
    return wave, sr


def analyze_volume(audio_path: Union[str, Path], sr: int = 22050, resolution: int = 20,
                   wave_sr: Optional[Tuple[np.ndarray, int]] = None) -> np.ndarray:
    """Normalized [0, 1] RMS loudness contour at `resolution` Hz (JAX:
    `analyze_volume` :159).

    Frames of 2 hops, centered with zero padding, as the reference's librosa
    RMS call; the sums of squares come from one cumulative sum.
    `wave_sr=(wave, native_sr)` reuses a waveform already decoded (the
    pipeline decodes origin.wav once), resampled as decoding would."""
    if wave_sr is not None:
        wave, native_sr = wave_sr
        wave = resample_audio(wave, native_sr, sr)
    else:
        wave, _ = decode_audio(audio_path, target_sr=sr, mono=True)
    hop = sr // resolution
    frame = hop * 2
    padded = np.pad(wave, frame // 2)
    n_frames = 1 + (len(padded) - frame) // hop if len(padded) >= frame else 0
    if n_frames <= 0:
        return np.zeros(0, np.float32)
    csum = np.concatenate(([0.0], np.cumsum(padded.astype(np.float64) ** 2)))
    starts = hop * np.arange(n_frames)
    rms = np.sqrt((csum[starts + frame] - csum[starts]) / frame)
    lo, hi = rms.min(), rms.max()
    if hi > lo:
        return ((rms - lo) / (hi - lo)).astype(np.float32)
    return np.zeros_like(rms, dtype=np.float32)


def save_volume_map(volume_map: np.ndarray, output_path: Union[str, Path]) -> None:
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    with open(output_path, "w", encoding="utf-8") as f:
        json.dump(np.asarray(volume_map, dtype=float).tolist(), f)
