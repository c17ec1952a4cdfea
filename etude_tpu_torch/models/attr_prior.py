"""Per-bar attribute bins predicted from the condition (source) bar:
`--attrs-prior` (the port's own copy of etude_tpu/models/attr_prior.py, which
is numpy). The predictor is trained by `scripts/train_attr_prior.py` (the
JAX package's script of that name wrote `checkpoints/attr_prior/`); either
package's `load` reads the other's `save`.

A per-attribute softmax regression from hand-made source-bar features to
the target's attribute bin. At inference it supplies per-bar bins (argmax,
or sampled at a temperature) in place of the one constant combo of
`--polyphony/--rhythm/--sustain`, conditioning the decoder the way its
training data did.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import json

import numpy as np
import torch

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

    def _norm(self, X: np.ndarray) -> np.ndarray:
        return (X - self.mean) / self.std

    @classmethod
    def fit(cls, X: np.ndarray, y: Dict[str, np.ndarray], steps: int = 4000,
            lr: float = 1.0, l2: float = 1e-5, seed: int = 0,
            device: Union[str, torch.device] = "cpu") -> "AttrPrior":
        """Full-batch gradient descent on each attribute's softmax regression
        (JAX :95), in f64 on `device`: X [N, N_FEATURES] (the script passes
        f64), y name → [N] int bins. The casts are JAX's: mean and std in
        f64, stored as f32 (the bias column kept at 0 and 1), the
        standardised X in f64; each W starts as 0.01 x numpy's
        `default_rng(seed)` normals, drawn per name in ATTR_NAMES order; the
        rate decays linearly to 0; the weights are stored as f32. The four
        regressions are independent and run as one batched loop."""
        X_t = torch.as_tensor(np.asarray(X), device=device)
        mean = X_t.mean(dim=0).float()
        std = X_t.std(dim=0, correction=0).clamp(min=1e-6).float()
        mean[0], std[0] = 0.0, 1.0  # bias feature stays 1
        Xn = (X_t - mean.double()) / std.double()

        rng = np.random.default_rng(seed)
        W = torch.as_tensor(np.stack([
            0.01 * rng.standard_normal((X.shape[1], N_BINS)).astype(np.float64)
            for _ in ATTR_NAMES]), device=device)                     # [A, F, 3]
        onehot = torch.as_tensor(np.stack([np.eye(N_BINS)[y[n]] for n in ATTR_NAMES]),
                                 device=device)                       # [A, N, 3]
        Xn_b = Xn.expand(len(ATTR_NAMES), *Xn.shape)
        Xn_bt = Xn_b.transpose(1, 2)
        n = float(len(Xn))
        for i in range(steps):
            p = torch.softmax(torch.bmm(Xn_b, W), dim=-1)
            grad = torch.bmm(Xn_bt, p - onehot) / n + l2 * W
            W -= lr * (1.0 - i / steps) * grad  # linear decay
        weights = {name: w.float().cpu().numpy() for name, w in zip(ATTR_NAMES, W)}
        return cls(weights, mean.cpu().numpy(), std.cpu().numpy())

    def probs(self, X: np.ndarray) -> Dict[str, np.ndarray]:
        Xn = self._norm(X)
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

    def accuracy(self, X: np.ndarray, y: Dict[str, np.ndarray]) -> Dict[str, float]:
        """Share of rows whose argmax bin is the label, per attribute (JAX
        :159)."""
        Xn = self._norm(X)
        return {n: float((np.argmax(Xn @ W, axis=1) == y[n]).mean())
                for n, W in self.weights.items()}

    def save(self, path: Union[str, Path], meta: Optional[Dict] = None) -> None:
        """`path/weights.npz` (`__mean__`, `__std__`, one array per name) and
        `meta` as `path/meta.json`, as the JAX package saves them (:167)."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        np.savez(path / "weights.npz", __mean__=self.mean, __std__=self.std, **self.weights)
        if meta is not None:
            with open(path / "meta.json", "w", encoding="utf-8") as f:
                json.dump(meta, f, indent=2)

    @classmethod
    def load(cls, path: Union[str, Path]) -> "AttrPrior":
        """From `path/weights.npz` as the JAX package saves it (JAX :184)."""
        with np.load(Path(path) / "weights.npz") as z:
            weights = {k: z[k] for k in z.files if not k.startswith("__")}
            mean = z["__mean__"] if "__mean__" in z.files else None
            std = z["__std__"] if "__std__" in z.files else None
            return cls(weights, mean, std)
