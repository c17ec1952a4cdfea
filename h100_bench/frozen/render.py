"""Songs for the analysis traffic, made from a seed.

Copies of the grid songs of `etude_tpu_torch/tools/synthetic_corpus.py`
`grid_song` (chords and a top line on an eighth-note grid in 4/4, the
first downbeat struck at 0.5 s) and of the port's synthetic piano
(`etude_tpu_torch/data/synthetic.py` `render_piano`: six decaying harmonics
with a 5 ms attack, lower notes ringing longer), the latter computed in
batches of notes on the device. Kept here so that a change to the program
cannot change the benchmark's audio.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

LEAD_SECONDS = 0.5


def grid_song(rng: np.random.Generator, eighth: float, seconds: float) -> List[Dict]:
    notes = []
    for k in range(int((seconds - LEAD_SECONDS - 1.0) / eighth)):
        if k > 0 and rng.random() > 0.7:
            continue
        onset = LEAD_SECONDS + k * eighth
        root = int(rng.integers(43, 56))
        chord = [root, root + int(rng.choice([3, 4])), root + 7]
        top = int(rng.integers(60, 85))
        for pitch in chord[:int(rng.integers(2, 4))] + [top]:
            length = int(rng.integers(1, 5)) * eighth * 0.9
            notes.append({"onset": round(onset, 6), "offset": round(onset + length, 6),
                          "pitch": pitch, "velocity": int(rng.integers(60, 111))})
    return notes


def render_piano(notes: List[Dict], seconds: float, sr: int, device="cpu",
                 n_harmonics: int = 6, batch: int = 256) -> np.ndarray:
    """The synth's samples [seconds * sr + 1] f32: each note's harmonics
    computed on `device` in float64, `batch` notes at a time, then mixed on
    the host in the notes' order (so the same notes give the same bits)."""
    import torch

    wave = np.zeros(int(seconds * sr) + 1, np.float32)
    for i in range(0, len(notes), batch):
        part = notes[i:i + batch]
        lengths = [int((n["offset"] - n["onset"]) * sr) for n in part]
        f0 = torch.tensor([440.0 * 2.0 ** ((n["pitch"] - 69) / 12.0) for n in part],
                          dtype=torch.float64, device=device)[:, None]
        amp = torch.tensor([0.25 * n["velocity"] / 127.0 for n in part],
                           dtype=torch.float64, device=device)[:, None]
        t = (torch.arange(max(lengths), dtype=torch.float64, device=device) / sr)[None]
        env = torch.exp(-t / (0.2 + 200.0 / f0)) * torch.clamp(t / 0.005, max=1.0)
        sig = torch.zeros_like(env)
        for h in range(1, n_harmonics + 1):
            audible = (f0 * h < sr / 2).to(torch.float64)   # a note stops at Nyquist
            sig += audible * (0.6 ** (h - 1)) * torch.sin(2 * np.pi * f0 * h * t)
        segs = (amp * env * sig).float().cpu().numpy()
        for note, n, seg in zip(part, lengths, segs):
            i0 = int(note["onset"] * sr)
            lo, hi = max(i0, 0), min(i0 + n, len(wave))
            if hi > lo:
                wave[lo:hi] += seg[lo - i0:hi - i0]
    peak = np.abs(wave).max()
    if peak > 1.0:
        wave /= peak
    return wave


def song_pcm(rng: np.random.Generator, bpm: float, seconds: float, sr: int,
             device="cpu") -> np.ndarray:
    """One song as 16-bit PCM samples: a grid song at `bpm` (an eighth is
    30 / bpm s), rendered and clipped to [-1, 1]."""
    wave = render_piano(grid_song(rng, 30.0 / bpm, seconds), seconds, sr, device)
    return (np.clip(wave, -1.0, 1.0) * 32767.0).astype(np.int16)
