"""Onset F1: transcription fidelity between two note lists (own copy of
etude_tpu/evaluation/metrics/onset_f1.py:18; the evaluation slice extends
this package).

The fidelity metric ("onset F1 vs reference", BASELINE.json):
one-to-one matching of note onsets within a time tolerance, optionally
pitch-exact (50 ms tolerance, pitch match required). Matching is greedy in
estimate order (nearest unused reference onset), which lower-bounds the
optimal bipartite matching mir_eval computes — identical in practice except
on dense near-tolerance clusters.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def onset_f1(
    reference: List[Dict],
    estimate: List[Dict],
    tolerance: float = 0.05,
    match_pitch: bool = True,
) -> Dict[str, float]:
    """Returns {precision, recall, f1, n_ref, n_est, n_match}."""
    n_ref, n_est = len(reference), len(estimate)
    if n_ref == 0 or n_est == 0:
        return {"precision": 0.0, "recall": 0.0, "f1": 0.0,
                "n_ref": n_ref, "n_est": n_est, "n_match": 0}

    ref = sorted(reference, key=lambda n: n["onset"])
    est = sorted(estimate, key=lambda n: n["onset"])
    ref_used = np.zeros(n_ref, bool)

    matches = 0
    ref_onsets = np.array([n["onset"] for n in ref])
    for note in est:
        lo = np.searchsorted(ref_onsets, note["onset"] - tolerance, "left")
        hi = np.searchsorted(ref_onsets, note["onset"] + tolerance, "right")
        best, best_dist = -1, np.inf
        for i in range(lo, hi):
            if ref_used[i]:
                continue
            if match_pitch and ref[i]["pitch"] != note["pitch"]:
                continue
            dist = abs(ref[i]["onset"] - note["onset"])
            if dist < best_dist:
                best, best_dist = i, dist
        if best >= 0:
            ref_used[best] = True
            matches += 1

    precision = matches / n_est
    recall = matches / n_ref
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall > 0 else 0.0)
    return {"precision": precision, "recall": recall, "f1": f1,
            "n_ref": n_ref, "n_est": n_est, "n_match": matches}
