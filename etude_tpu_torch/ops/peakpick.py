"""Frame activations → discrete notes, in numpy (JAX counterpart:
etude_tpu/ops/peakpick.py, `detect_peaks` :26, `_next_below` :67,
`activations_to_notes` :75; the port's own copy, same semantics).

Run-length peak detection plus precomputed next-below-threshold indices, in
place of the reference's O(pitches × frames²) Python loops
(etude/data/extractor.py:256-418), keeping its rules:

  * a frame is an onset/offset peak iff its activation ≥ threshold and the
    nearest *differing* values on both sides are smaller (plateaus count as
    peaks across their full width; array boundaries count as smaller);
  * sub-frame peak time via the reference's asymmetric interpolation rule;
  * per note: offset = first offset-peak after the onset (clamped to the next
    onset), frame(MPE) offset = first frame below threshold before the next
    onset, combined with the 'shorter'/'longer'/'offset' policy;
  * velocity from the classifier argmax at the onset frame, zero-velocity
    notes dropped ('ignore_zero'), overlapping same-pitch notes truncated.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def detect_peaks(act: np.ndarray, thr: float, hop_sec: float
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Plateau-aware local maxima of one activation column.

    Returns (locs [int frames], times [interpolated seconds]).
    """
    T = len(act)
    if T == 0:
        return np.empty(0, np.int64), np.empty(0, np.float64)

    # Run-length segmentation of equal consecutive values.
    change = np.flatnonzero(act[1:] != act[:-1])
    run_starts = np.concatenate([[0], change + 1])
    run_vals = act[run_starts]
    prev_vals = np.concatenate([[-np.inf], run_vals[:-1]])
    next_vals = np.concatenate([run_vals[1:], [-np.inf]])
    run_is_peak = (run_vals >= thr) & (prev_vals < run_vals) & (next_vals < run_vals)

    run_id = np.zeros(T, np.int64)
    run_id[run_starts[1:]] = 1
    run_id = np.cumsum(run_id)
    peak = run_is_peak[run_id]
    locs = np.flatnonzero(peak)
    if len(locs) == 0:
        return locs, np.empty(0, np.float64)

    times = locs.astype(np.float64) * hop_sec
    interior = (locs > 0) & (locs < T - 1)
    li = locs[interior]
    if len(li):
        a_c, a_l, a_r = act[li], act[li - 1], act[li + 1]
        with np.errstate(divide="ignore", invalid="ignore"):
            shift_l = hop_sec * 0.5 * (a_l - a_r) / (a_c - a_r)
            shift_r = hop_sec * 0.5 * (a_r - a_l) / (a_c - a_l)
        t = li * hop_sec
        t = np.where(a_l > a_r, li * hop_sec - shift_l,
                     np.where(a_l < a_r, li * hop_sec + shift_r, t))
        times[interior] = t
    return locs, times


def _next_below(mask_below: np.ndarray) -> np.ndarray:
    """next_below[i] = smallest index >= i where mask is True (len(mask) if
    none)."""
    T = len(mask_below)
    idx = np.where(mask_below, np.arange(T), T)
    return np.minimum.accumulate(idx[::-1])[::-1]


def activations_to_notes(
    onset: np.ndarray,      # [T, n_note] f32
    offset: np.ndarray,     # [T, n_note] f32
    mpe: np.ndarray,        # [T, n_note] f32
    velocity: np.ndarray,   # [T, n_note] int (argmax of classifier)
    *,
    hop_sec: float,
    note_min: int = 21,
    thred_onset: float = 0.5,
    thred_offset: float = 0.5,
    thred_mpe: float = 0.5,
    mode_velocity: str = "ignore_zero",
    mode_offset: str = "shorter",
) -> List[Dict]:
    """Frame activation maps → sorted list of note dicts."""
    T, n_note = onset.shape
    notes: List[Dict] = []

    for j in range(n_note):
        on_locs, on_times = detect_peaks(onset[:, j], thred_onset, hop_sec)
        if len(on_locs) == 0:
            continue
        off_locs, off_times = detect_peaks(offset[:, j], thred_offset, hop_sec)
        mpe_next_below = _next_below(mpe[:, j] < thred_mpe)

        pitch = int(j + note_min)
        last_kept = None  # index into notes of the previous kept note (pitch j)

        for k in range(len(on_locs)):
            loc_onset = int(on_locs[k])
            time_onset = float(on_times[k])
            if k + 1 < len(on_locs):
                loc_next = int(on_locs[k + 1])
                time_next = float(on_times[k + 1])
            else:
                loc_next = T
                time_next = (T - 1) * hop_sec

            # First offset peak strictly after the onset frame.
            off_idx = int(np.searchsorted(off_locs, loc_onset, side="right"))
            flag_offset = off_idx < len(off_locs)
            if flag_offset:
                loc_offset = int(off_locs[off_idx])
                time_offset = float(off_times[off_idx])
                if loc_offset > loc_next:
                    loc_offset = loc_next
                    time_offset = time_next
            else:
                loc_offset, time_offset = loc_onset + 1, 0.0

            # First frame below the MPE threshold in (onset, next onset).
            start = min(loc_onset + 1, T)
            cand = int(mpe_next_below[start]) if start < T else T
            flag_mpe = cand < loc_next
            loc_mpe = cand if flag_mpe else loc_onset + 1
            time_mpe = loc_mpe * hop_sec

            if not flag_offset and not flag_mpe:
                offset_value = time_next
            elif flag_offset and not flag_mpe:
                offset_value = time_offset
            elif not flag_offset and flag_mpe:
                offset_value = time_mpe
            elif mode_offset == "offset":
                offset_value = time_offset
            elif mode_offset == "longer":
                offset_value = time_offset if loc_offset >= loc_mpe else time_mpe
            else:  # shorter
                offset_value = time_offset if loc_offset <= loc_mpe else time_mpe

            vel = int(velocity[loc_onset, j])
            if mode_velocity == "ignore_zero" and vel <= 0:
                continue

            note = {
                "pitch": pitch,
                "onset": float(time_onset),
                "offset": float(offset_value),
                "velocity": vel,
            }
            notes.append(note)
            # Truncate the previous same-pitch note if it overlaps this one.
            if last_kept is not None and notes[last_kept]["offset"] > note["onset"]:
                notes[last_kept]["offset"] = note["onset"]
            last_kept = len(notes) - 1

    notes.sort(key=lambda n: (n["onset"], n["pitch"]))
    return notes
