"""Per-bar attribute bins predicted from the condition (source) bar:
`--attrs-prior` (the port's own copy of etude_tpu/models/attr_prior.py, which
is numpy; the predictor is trained by the JAX package's
scripts/train_attr_prior.py into `checkpoints/attr_prior/weights.npz`).

A per-attribute softmax regression from hand-made source-bar features to
the target's attribute bin. At inference it supplies per-bar bins (argmax,
or sampled at a temperature) in place of the one constant combo of
`--polyphony/--rhythm/--sustain`, conditioning the decoder the way its
training data did.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from ..data.dataset import extract_bar_features

ATTR_NAMES = (
    "relative_polyphony",
    "relative_rhythmic_intensity",
    "relative_note_sustain",
    "pitch_overlap_ratio",
)
NAME_TO_KEY = {
    "relative_polyphony": "polyphony_bin",
    "relative_rhythmic_intensity": "rhythm_intensity_bin",
    "relative_note_sustain": "sustain_bin",
    "pitch_overlap_ratio": "pitch_overlap_bin",
}
N_BINS = 3
N_FEATURES = 10


def bar_feature_vector(feats: Dict[str, Any], bar_idx: int, n_bars: int) -> np.ndarray:
    """Source-bar features (`data.dataset.extract_bar_features`) →
    [N_FEATURES] f32 (JAX :50)."""
    notes = feats["note_count"]
    poss = feats["pos_event_count"]
    dur = feats["total_duration_in_16ths"]
    pitches = [p for ps in feats["notes_by_position"].values() for p in ps]
    pitch_arr = np.asarray(pitches, np.float32) if pitches else np.zeros(1)
    frac = bar_idx / max(n_bars - 1, 1)
    return np.asarray([
        1.0,
        np.log1p(notes),
        np.log1p(poss),
        notes / max(poss, 1),
        dur / max(notes, 1) / 8.0,
        (pitch_arr.max() - pitch_arr.min()) / 48.0 if pitches else 0.0,
        pitch_arr.mean() / 64.0 - 1.0 if pitches else 0.0,
        len({int(p) % 12 for p in pitches}) / 12.0,
        frac,
        np.sin(np.pi * frac),
    ], np.float32)


def _softmax(z: np.ndarray) -> np.ndarray:
    z = z - z.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


class AttrPrior:
    """Per-attribute softmax regression over standardized bar features (JAX
    :81)."""

    def __init__(self, weights: Dict[str, np.ndarray],
                 mean: Optional[np.ndarray] = None,
                 std: Optional[np.ndarray] = None):
        self.weights = weights  # name → [N_FEATURES, N_BINS]
        self.mean = mean if mean is not None else np.zeros(N_FEATURES, np.float32)
        self.std = std if std is not None else np.ones(N_FEATURES, np.float32)

    def probs(self, X: np.ndarray) -> Dict[str, np.ndarray]:
        Xn = (X - self.mean) / self.std
        return {n: _softmax(Xn @ W) for n, W in self.weights.items()}

    def predict_bins(self, bars: Sequence[Sequence[int]], vocab, temperature: float = 0.0,
                     seed: int = 0) -> List[Dict[str, int]]:
        """Per-bar engine attribute dicts for a song's source bars: argmax at
        temperature 0, else drawn from the tempered softmax with numpy's
        generator seeded by `seed` (JAX :132)."""
        rng = np.random.default_rng(seed)
        X = np.stack([bar_feature_vector(extract_bar_features(bar, vocab), i, len(bars))
                      for i, bar in enumerate(bars)])
        all_probs = self.probs(X)
        out: List[Dict[str, int]] = []
        for i in range(len(bars)):
            attrs = {}
            for name in ATTR_NAMES:
                p = all_probs[name][i]
                if temperature > 0:
                    p = _softmax((np.log(np.maximum(p, 1e-9)) / temperature)[None])[0]
                    b = int(rng.choice(N_BINS, p=p))
                else:
                    b = int(np.argmax(p))
                attrs[NAME_TO_KEY[name]] = b
            out.append(attrs)
        return out

    @classmethod
    def load(cls, path: Union[str, Path]) -> "AttrPrior":
        """From `path/weights.npz` as the JAX package saves it (JAX :184)."""
        with np.load(Path(path) / "weights.npz") as z:
            weights = {k: z[k] for k in z.files if not k.startswith("__")}
            mean = z["__mean__"] if "__mean__" in z.files else None
            std = z["__std__"] if "__std__" in z.files else None
            return cls(weights, mean, std)
