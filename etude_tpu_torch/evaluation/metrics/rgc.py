"""Rhythmic Grid Consistency (JAX counterpart: etude_tpu/evaluation/metrics/rgc.py,
of which this is the port's own copy).

From unique onsets → IOIs → the top-k most common (rounded) IOIs; the grid
period τ is the candidate minimizing the mean |ratio − round(ratio)| over
those IOIs. Lower = steadier rhythmic grid.
"""

from __future__ import annotations

from collections import Counter
from pathlib import Path

import numpy as np

from .base_metric import get_onsets_from_file


class RGCCalculator:
    def __init__(self, top_k: int = 8, precision_digits: int = 4, **_):
        self.top_k = top_k
        self.precision_digits = precision_digits

    def calculate(self, file_path: Path) -> dict:
        onsets = get_onsets_from_file(file_path)
        if len(onsets) < 2:
            return {"error": "not enough onsets"}
        iois = np.diff(onsets)
        if len(iois) < self.top_k:
            return {"error": "not enough IOIs"}

        counts = Counter(np.round(iois, self.precision_digits))
        if len(counts) < 2:
            return {"error": "not enough unique IOIs"}
        top = np.array([ioi for ioi, _ in counts.most_common(self.top_k)])

        best_tau, best_dev = -1.0, float("inf")
        for tau in top:
            if tau < 0.01:
                continue
            ratios = top / tau
            dev = float(np.mean(np.abs(ratios - np.round(ratios))))
            if dev < best_dev:
                best_tau, best_dev = float(tau), dev
        if best_tau < 0:
            return {"error": "could not infer a grid period"}
        return {"rgc_score": best_dev, "inferred_tau": best_tau}
