"""The beat-grid helpers of the decoder's distillation-dataset builder (JAX
counterpart: scripts/distill_dataset.py :50-131).

The reference's decoder outputs were generated bar by bar on a beat grid,
so their onsets sit on sub-beat slots of that grid. `estimate_tempo_grid`
recovers a constant 4/4 grid from the onsets alone and `grid_fit_score`
measures how tightly the onsets snap to a grid's eighth-beat slots; the
beat scripts (validate_beat_corpus, gen_beat_scenes) and `train_aux
beat-corpus` keep only songs whose grid they recover within a snap gate.

This module holds only these helpers for now. The builder itself (its
tracker grid, the tokenizer pass and the CLI) is ported with the
decoder-corpus scripts, the next slice (ROADMAP.md Queue 1 item 5).
"""

from __future__ import annotations

from collections import Counter

import numpy as np


def estimate_tempo_grid(notes, min_bpm=70.0, max_bpm=180.0):
    """4/4 grid from note onsets: infer the dominant IOI period, scale it by
    powers of two into the BPM range, anchor downbeats at the first onset."""
    onsets = np.unique([n["onset"] for n in notes])
    if len(onsets) < 16:
        return None
    iois = np.diff(onsets)
    counts = Counter(np.round(iois, 2))
    candidates = [v for v, _ in counts.most_common(8) if v >= 0.05]
    if not candidates:
        return None

    best_tau, best_dev = None, np.inf
    arr = np.array(candidates)
    for tau in arr:
        ratios = arr / tau
        dev = float(np.mean(np.abs(ratios - np.round(ratios))))
        if dev < best_dev:
            best_tau, best_dev = float(tau), dev

    beat = best_tau
    lo, hi = 60.0 / max_bpm, 60.0 / min_bpm
    while beat < lo:
        beat *= 2
    while beat > hi:
        beat /= 2
    bpm = 60.0 / beat

    start = float(onsets[0])
    end = float(max(n["offset"] for n in notes))
    bar = 4 * beat
    n_bars = max(int(np.ceil((end - start) / bar)), 1)
    downbeats = [round(start + i * bar, 6) for i in range(n_bars)]
    return [{
        "time_sig": 4,
        "bpm": round(bpm, 4),
        "start": downbeats[0],
        "downbeats": downbeats,
    }]


def grid_slot_times(tempo, horizon: float) -> np.ndarray:
    """All eighth-note slot times implied by a tempo map (the tokenizer's
    sub-beat resolution is eighths of a beat; scoring at beat/8 keeps the
    triplet slots within half a slot of a grid line)."""
    slots = []
    for region in tempo:
        downbeats = list(region["downbeats"])
        if not downbeats:
            continue
        beat = 60.0 / region["bpm"]
        ts = region["time_sig"]
        bar = beat * ts
        downbeats.append(downbeats[-1] + bar)
        for a, b in zip(downbeats[:-1], downbeats[1:]):
            n = max(int(round((b - a) / beat)) * 8, 8)
            slots.append(np.linspace(a, b, n, endpoint=False))
    if not slots:
        return np.zeros(0)
    out = np.concatenate(slots)
    return out[out <= horizon + 1.0]


def grid_fit_score(notes, tempo) -> float:
    """Mean onset distance to the nearest grid slot, in seconds (lower is
    better). A MIDI generated on a grid scores near zero on that grid."""
    onsets = np.unique([n["onset"] for n in notes])
    if len(onsets) == 0 or not tempo:
        return np.inf
    slots = grid_slot_times(tempo, horizon=float(onsets[-1]))
    if len(slots) < 8:
        return np.inf
    idx = np.searchsorted(slots, onsets)
    idx = np.clip(idx, 1, len(slots) - 1)
    d = np.minimum(np.abs(onsets - slots[idx - 1]), np.abs(onsets - slots[idx]))
    return float(d.mean())
