"""Pseudo-pop five-stem construction from corpus piano MIDI (JAX
counterpart: etude_tpu/data/pseudopop.py).

Given a corpus piano cover's notes and its known beat grid, derive a
five-stem pop arrangement —

    vocals  formant-synth lead from the top line (+12 semitones)
    piano   the cover itself
    guitar  sustained per-bar chord pad
    bass    root line riding the beat
    drums   kick/snare/hat locked to the grid

— and mix it through the serving int16 path. The separator's pseudo-pop
evaluation (scripts/eval_separator_pseudopop.py), its pseudo-pop training
rows (`train_aux separator --pseudopop-mix`, scripts/
gen_pseudopop_sep_examples.py) and the pseudo-pop beat scenes
(scripts/gen_pseudopop_scenes.py) all build their mixtures here, so train
and eval share one implementation. The renderers live in data/synthetic.py;
this module only arranges. Given the same inputs and generator, every
function returns arrays bit-equal to the JAX package's
(tests/test_torch_corpus_data.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .synthetic import (
    render_bass,
    render_drums,
    render_pad,
    render_piano,
    render_vocal,
)

STEM_NAMES = ("vocals", "piano", "guitar", "bass", "drums")
MIX_GAINS = {"vocals": 0.9, "piano": 1.0, "guitar": 0.55, "bass": 0.8,
             "drums": 0.9}


def _onset_groups(notes, tol: float = 0.03):
    """Notes clustered by onset time (sorted)."""
    groups = []
    for n in sorted(notes, key=lambda d: d["onset"]):
        if groups and n["onset"] - groups[-1][0]["onset"] <= tol:
            groups[-1].append(n)
        else:
            groups.append([n])
    return groups


def melody_line(notes, dur: float):
    """Top line (+12 semitones), monophonic, clipped at the next onset."""
    groups = _onset_groups(notes)
    line = []
    for g in groups:
        top = max(g, key=lambda d: d["pitch"])
        if top["pitch"] < 55:
            continue
        line.append(dict(top))
    out = []
    for i, n in enumerate(line):
        end = line[i + 1]["onset"] if i + 1 < len(line) else n["offset"]
        off = min(n["offset"] + 0.1, max(end, n["onset"] + 0.15), dur)
        if off - n["onset"] < 0.05:
            continue
        out.append({"onset": n["onset"], "offset": off,
                    "pitch": min(n["pitch"] + 12, 103),
                    "velocity": n["velocity"]})
    return out


def bass_line(notes, beats: np.ndarray, dur: float):
    """Lowest sounding pitch at each beat, folded into E1–B2, held to the
    next beat."""
    out = []
    for i, b in enumerate(beats):
        sounding = [n for n in notes if n["onset"] <= b + 0.05
                    and n["offset"] > b]
        if not sounding:
            continue
        p = min(n["pitch"] for n in sounding)
        while p > 47:
            p -= 12
        while p < 28:
            p += 12
        end = beats[i + 1] if i + 1 < len(beats) else b + 0.5
        out.append({"onset": float(b), "offset": float(min(end, dur)),
                    "pitch": int(p), "velocity": 96})
    return out


def pad_chords(notes, downs: np.ndarray, dur: float):
    """Per-bar: up to 3 distinct pitch classes voiced at E3–G4, sustained
    for the bar."""
    out = []
    for i, d0 in enumerate(downs):
        d1 = downs[i + 1] if i + 1 < len(downs) else d0 + 2.0
        in_bar = [n for n in notes if d0 <= n["onset"] < d1]
        if not in_bar:
            continue
        classes = []
        for n in sorted(in_bar, key=lambda x: -x["offset"] + x["onset"]):
            pc = n["pitch"] % 12
            if pc not in classes:
                classes.append(pc)
            if len(classes) == 3:
                break
        for k, pc in enumerate(classes):
            p = 52 + ((pc - 52) % 12)
            out.append({"onset": float(d0), "offset": float(min(d1, dur)),
                        "pitch": int(p + (12 if k == 2 and p < 60 else 0)),
                        "velocity": 80})
    return out


def stft_mag(wave: np.ndarray, n_fft: int = 4096, hop: int = 1024,
             n_frames: Optional[int] = None) -> np.ndarray:
    """|STFT| magnitude [T, n_fft//2+1] matching the serving separation
    transform (data/separation.py `stft_power`): host reflect center-pad,
    periodic Hann `0.5*(1-cos(2πn/N))`, rfft magnitude.

    Training the separator on these magnitudes keeps the train/serving
    signal chain identical (pad_bucket_wave + frame_power_spectrum)."""
    wave = np.asarray(wave, np.float32)
    pad = n_fft // 2
    padded = (np.pad(wave, pad, mode="reflect") if len(wave) > pad
              else np.pad(wave, pad, mode="constant"))
    total = 1 + (len(padded) - n_fft) // hop
    T = total if n_frames is None else min(n_frames, total)
    idx = np.arange(n_fft)[None, :] + hop * np.arange(T)[:, None]
    n = np.arange(n_fft)
    window = (0.5 * (1.0 - np.cos(2 * np.pi * n / n_fft))).astype(np.float32)
    spec = np.fft.rfft(padded[idx] * window[None, :], axis=1)
    mag = np.abs(spec).astype(np.float32)
    if n_frames is not None and T < n_frames:
        mag = np.pad(mag, ((0, n_frames - T), (0, 0)))
    return mag


def separation_example_from_stems(
    mix: np.ndarray,
    stems: Dict[str, np.ndarray],
    T: int = 256,
) -> Dict[str, np.ndarray]:
    """(mix, gain-scaled stems) → the separator training contract
    {mix_mag [T, F], stem_mags [5, T, F]} through the serving STFT.

    mix_mag comes from the int16-quantized mixture (what serving sees);
    stem targets from the clean gain-scaled stems. Ideal ratio masks are
    then exactly stem/mix up to the quantization noise."""
    return {
        "mix_mag": stft_mag(mix, n_frames=T),
        "stem_mags": np.stack(
            [stft_mag(stems[k], n_frames=T) for k in STEM_NAMES]
        ),
    }


def build_stems(
    notes: List[Dict],
    beats: np.ndarray,
    downs: np.ndarray,
    dur: float,
    sr: int,
    seed: int,
    gains: Optional[Dict[str, float]] = None,
    drum_jitter: float = 0.0,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, Dict[str, np.ndarray], np.ndarray]:
    """(mix, per-stem waves, beat times) for a pseudo-pop arrangement.

    `gains`: per-stem mix gains (defaults MIX_GAINS); a gain of 0 drops the
    stem entirely (training augmentation — e.g. percussion-less scenes).
    `drum_jitter`: σ of Gaussian timing noise (s) added to the drums' beat
    and downbeat anchors (humanization); beat LABELS stay on the true grid.
    """
    gains = dict(MIX_GAINS if gains is None else gains)
    beats = np.asarray(beats, float)
    downs = np.asarray(downs, float)
    drum_beats, drum_downs = beats, downs
    if drum_jitter > 0:
        rng = rng or np.random.default_rng(seed)
        drum_beats = beats + np.clip(
            rng.normal(0.0, drum_jitter, len(beats)),
            -2 * drum_jitter, 2 * drum_jitter)
        drum_downs = np.asarray(
            [drum_beats[np.abs(beats - t).argmin()] for t in downs], float
        ) if len(downs) else downs
    n = int(dur * sr) + 1
    zero = np.zeros(n, np.float32)
    stems = {
        "vocals": render_vocal(melody_line(notes, dur), dur, sr=sr)
        if gains.get("vocals") else zero,
        "piano": render_piano(notes, dur, sr=sr)
        if gains.get("piano") else zero,
        "guitar": render_pad(pad_chords(notes, downs, dur), dur, sr=sr)
        if gains.get("guitar") else zero,
        "bass": render_bass(bass_line(notes, beats, dur), dur, sr=sr)
        if gains.get("bass") else zero,
        "drums": render_drums(drum_beats, drum_downs, dur, sr=sr, seed=seed)
        if gains.get("drums") else zero,
    }
    stems = {k: np.pad(v, (0, max(0, n - len(v))))[:n].astype(np.float32)
             for k, v in stems.items()}
    mix = sum(gains.get(k, 0.0) * stems[k] for k in STEM_NAMES)
    scale = 0.9 / max(float(np.abs(mix).max()), 1e-6)
    mix = mix * scale
    stems = {k: gains.get(k, 0.0) * stems[k] * scale for k in STEM_NAMES}
    # Serving int16 WAV quantization on the mixture.
    mix = (np.clip(mix, -1, 1) * 32767).astype(np.int16).astype(
        np.float32) / 32767.0
    return mix, stems, beats
