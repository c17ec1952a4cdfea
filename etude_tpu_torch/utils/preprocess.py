"""Data-prep utilities on the host, in numpy (JAX counterpart:
etude_tpu/utils/preprocess.py, of which this is the port's own copy): the
WP-Std quality metric, downbeat→cover time maps, weak alignment of
transcriptions onto the origin timeline. Volume analysis lives in
utils/audio and is re-exported here for surface parity."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .audio import analyze_volume, save_volume_map  # noqa: F401 (re-export)


def compute_wp_std(time_map: List[List[float]]) -> float:
    """Std of (origin − cover) time differences (WP-Std data-quality filter)."""
    if not time_map:
        return float("inf")
    diffs = [pair[0] - pair[1] for pair in time_map]
    return float(np.std(diffs))


def create_time_map_from_downbeats(
    downbeats: List[float],
    align_result: Dict,
    feature_rate: int = 50,
) -> List[List[float]]:
    """[origin_time, cover_time] anchors at each origin downbeat, via the
    warping path (wp[0]=cover frames, wp[1]=origin frames)."""
    wp = np.asarray(align_result["wp"])
    t_origin = wp[1] / feature_rate
    t_cover = wp[0] / feature_rate

    order = np.argsort(t_origin)
    t_origin, t_cover = t_origin[order], t_cover[order]

    time_map = []
    for db in downbeats:
        if db <= t_origin[-1]:
            cover_t = float(np.interp(db, t_origin, t_cover))
            time_map.append([float(db), cover_t])
    return time_map


def weakly_align(
    transcription_notes: List[Dict],
    time_map: List[List[float]],
) -> List[Dict]:
    """Piecewise-linearly remap cover-time onsets onto the origin timeline,
    preserving note durations (reference weak-alignment semantics: notes
    outside the mapped cover range are dropped; the final segment is
    extended by an identity-slope 10 s tail)."""
    if not time_map or not transcription_notes:
        return []

    anchors = sorted(time_map, key=lambda p: p[1])
    notes = sorted(transcription_notes, key=lambda n: n["onset"])

    aligned = []
    idx = 0
    for note in notes:
        t_on = note["onset"]
        duration = note["offset"] - t_on
        while idx + 1 < len(anchors) and t_on >= anchors[idx + 1][1]:
            idx += 1
        s1, p1 = anchors[idx]
        if idx + 1 < len(anchors):
            s2, p2 = anchors[idx + 1]
        else:
            s2, p2 = s1 + 10.0, p1 + 10.0
        seg = p2 - p1
        if seg < 1e-6:
            continue
        if p1 <= t_on < p2:
            rel = (t_on - p1) / seg
            new_onset = s1 + rel * (s2 - s1)
            aligned.append({
                "pitch": note["pitch"],
                "onset": new_onset,
                "offset": new_onset + duration,
                "velocity": note["velocity"],
            })
    return aligned
