"""Warping Path Deviation (JAX counterpart: etude_tpu/evaluation/metrics/wpd.py,
of which this is the port's own copy).

Fits a linear regression to the DTW warping path between cover and origin
timelines; the score is the standard deviation of the residuals. Optional
path subsampling and end trimming.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class WPDCalculator:
    def __init__(self, subsample_step: int = 1, trim_seconds: float = 0, **_):
        if not isinstance(subsample_step, int) or subsample_step < 1:
            raise ValueError("subsample_step must be an integer >= 1")
        if trim_seconds < 0:
            raise ValueError("trim_seconds must be >= 0")
        self.subsample_step = subsample_step
        self.trim_seconds = trim_seconds

    def calculate(self, align_result: Dict, feature_rate: int = 50) -> Dict:
        wp = align_result.get("wp")
        n_cover = align_result.get("num_frames_cover")
        n_origin = align_result.get("num_frames_origin")
        if wp is None or n_cover is None or n_origin is None:
            return {"error": "alignment result missing wp/num_frames keys"}

        wp = np.asarray(wp)[:, ::self.subsample_step]
        if wp.shape[1] < 10:
            return {"error": "not enough warping-path points"}

        t_cover = np.clip(wp[0], 0, n_cover - 1) / feature_rate
        t_origin = np.clip(wp[1], 0, n_origin - 1) / feature_rate

        if self.trim_seconds > 0 and t_origin[-1] > 2 * self.trim_seconds:
            mask = (t_origin >= self.trim_seconds) & (
                t_origin <= t_origin[-1] - self.trim_seconds
            )
            if mask.sum() > 10:
                t_cover, t_origin = t_cover[mask], t_origin[mask]

        a, b = np.polyfit(t_cover, t_origin, 1)
        deviation = t_origin - (a * t_cover + b)
        return {"wpd_score": float(np.std(deviation))}
