"""Tempo-octave disambiguation for DBN beat output (the port's own copy of
etude_tpu/ops/beat_octave.py, which imports no JAX).

The beat tracker's dominant failure mode on piano-dominant audio is the
tempo octave: the DBN locks to half or double the true beat rate (the
corpus study in PARITY.md shows octave-tolerant F well above strict F —
0.410 vs 0.324 — i.e. a large share of the error is octave choice, not
phase). madmom's DBN has the same ambiguity; the reference simply inherits
it (etude/data/beat_detector.py:131-144 decodes the activation with fixed
[70, 250] BPM bounds and keeps whatever octave the HMM picks).

This pass re-scores the DBN's beat sequence against the model's own beat
activation curve under the three candidate octaves:

    identity      the DBN beats as decoded
    double        midpoints inserted between consecutive beats
    half (x2)     every other beat kept (both phases tried)

Each candidate is scored by the mean activation at its beat times minus
the mean activation at its midpoints (a grid aligned with the true beats
has high on-beat and low off-beat activation; a half-time grid leaves the
true off-beats' high activation in its midpoints, a double-time grid puts
midpoints into activation valleys). A candidate must beat the identity
score by a decisive margin AND keep its implied tempo inside the DBN's
own [min_bpm, max_bpm] band to be adopted — ties keep the DBN output, so
the pass is conservative by construction.

Pure numpy post-processing: no model change, no retraining, composes with
any checkpoint.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _grid_score(beats: np.ndarray, activation: np.ndarray,
                fps: float) -> float:
    """Mean on-beat activation minus mean midpoint activation."""
    if len(beats) < 4:
        return -np.inf
    frames = np.arange(len(activation), dtype=np.float64) / fps
    on = np.interp(beats, frames, activation)
    mids = beats[:-1] + np.diff(beats) / 2.0
    off = np.interp(mids, frames, activation)
    return float(on.mean() - off.mean())


def _median_bpm(beats: np.ndarray) -> float:
    if len(beats) < 2:
        return 0.0
    d = np.diff(beats)
    d = d[d > 1e-3]
    return 60.0 / float(np.median(d)) if len(d) else 0.0


def disambiguate_octave(
    beats: np.ndarray,
    activation: np.ndarray,
    fps: float,
    min_bpm: float = 70.0,
    max_bpm: float = 250.0,
    margin: float = 1.5,
    min_abs_margin: float = 0.02,
) -> Tuple[np.ndarray, Optional[str]]:
    """Return (possibly octave-corrected beats, applied-candidate-or-None).

    `activation`: the beat channel of the tracker's sigmoid output [T].
    `margin`: a candidate must score at least `margin` times the identity
    score (and identity must not already be decisively good) to be adopted.
    `min_abs_margin`: absolute score floor on top of the relative rule, so
    near-tie flips on weak/noisy near-flat activations are rejected even
    when the identity score is non-positive.
    """
    beats = np.asarray(beats, dtype=np.float64)
    if len(beats) < 8 or len(activation) < 8:
        return beats, None

    base = _grid_score(beats, activation, fps)

    candidates = {}
    mids = beats[:-1] + np.diff(beats) / 2.0
    candidates["double"] = np.sort(np.concatenate([beats, mids]))
    candidates["half_even"] = beats[0::2]
    candidates["half_odd"] = beats[1::2]

    best_name, best_beats, best_score = None, beats, base
    for name, cand in candidates.items():
        bpm = _median_bpm(cand)
        if not (min_bpm <= bpm <= max_bpm):
            continue
        score = _grid_score(cand, activation, fps)
        # Adoption rule: decisively better than the DBN's own octave. For
        # non-positive base scores (identity midpoints hotter than its
        # beats — a strong octave-error signal) the candidate still has to
        # clear an absolute margin, not just be infinitesimally positive.
        threshold = max(
            base * margin if base > 0 else 0.0,
            base + min_abs_margin,
            min_abs_margin,
        )
        if score > threshold and score > best_score:
            best_name, best_beats, best_score = name, cand, score
    return best_beats, best_name
