"""Stage-2 part 3: tempo/measure analysis of beat predictions (the port's own
copy of etude_tpu/data/beat_analyzer.py, which imports no JAX).

Behavioral parity with the reference BeatAnalyzer
(etude/data/beat_analyzer.py): drop beats within 0.1 s of downbeats, group
beats into measures with a uniformity test, derive a global time signature
(mode of uniform measures' beat counts, 2 remapped to 4), detect stable-tempo
regions by sliding-window duration consistency with greedy extension, patch
inter-region gaps with whole/half measures, and merge adjacent regions with
equal time signature and near-equal BPM. Output: a list of
{time_sig, bpm, start, downbeats[]} regions (the tempo.json contract).
"""

from __future__ import annotations

import json
import math
from collections import Counter
from pathlib import Path
from typing import Dict, List, Union

import numpy as np

from ..utils.logger import logger


class BeatAnalyzer:
    """Pure-host analysis; all heuristics vectorized with numpy where hot."""

    def analyze_predictions(
        self, beat_pred: List[float], downbeat_pred: List[float]
    ) -> List[Dict]:
        if not downbeat_pred:
            logger.warn("no downbeats predicted; cannot analyze tempo")
            return []

        beats = self._drop_beats_near_downbeats(
            np.asarray(beat_pred, float), np.asarray(downbeat_pred, float)
        )
        measures = self._group_measures(beats, np.asarray(downbeat_pred, float))
        if not measures:
            logger.warn("no valid measures computed")
            return []

        time_sig = self._global_time_signature(measures)
        regions = self._stable_regions(measures)

        processed = []
        for start_idx, end_idx in regions:
            span = measures[start_idx:end_idx + 1]
            downbeats = [m["start"] for m in span]
            if end_idx + 1 < len(measures):
                downbeats.append(measures[end_idx + 1]["start"])
            durations = np.diff(downbeats)
            if len(durations) == 0:
                continue
            avg = float(durations.mean())
            processed.append({
                "start_time": downbeats[0],
                "downbeats": downbeats[:-1],
                "avg_duration": avg,
                "bpm": (60.0 * time_sig) / avg if avg > 0 else 0.0,
                "time_sig": time_sig,
            })
        if not processed:
            logger.warn("no stable tempo regions detected")
            return []

        merged = self._patch_gaps_and_merge(processed)
        return [
            {
                "time_sig": r["time_sig"],
                "bpm": r["bpm"],
                "start": r["start_time"],
                "downbeats": r["downbeats"],
            }
            for r in merged
        ]

    def analyze(self, beat_file_path: Union[str, Path]) -> List[Dict]:
        """Reference CLI surface: read beat_pred.json, return tempo regions."""
        with open(beat_file_path, "r", encoding="utf-8") as f:
            data = json.load(f)
        return self.analyze_predictions(
            data.get("beat_pred", []), data.get("downbeat_pred", [])
        )

    @staticmethod
    def save_tempo_data(tempo_data: List[Dict], output_path: Union[str, Path]):
        output_path = Path(output_path)
        output_path.parent.mkdir(parents=True, exist_ok=True)
        with open(output_path, "w", encoding="utf-8") as f:
            json.dump(tempo_data, f, indent=4)

    # ---- heuristics ----------------------------------------------------
    @staticmethod
    def _drop_beats_near_downbeats(
        beats: np.ndarray, downbeats: np.ndarray, threshold: float = 0.1
    ) -> np.ndarray:
        if beats.size == 0 or downbeats.size == 0:
            return beats
        dist = np.abs(beats[:, None] - downbeats[None, :]).min(axis=1)
        return beats[dist >= threshold]

    @staticmethod
    def _group_measures(
        beats: np.ndarray, downbeats: np.ndarray,
        uniformity_threshold: float = 0.1,
    ) -> List[Dict]:
        measures = []
        for i in range(len(downbeats) - 1):
            start, end = downbeats[i], downbeats[i + 1]
            inside = beats[(beats > start) & (beats < end)]
            grid = np.concatenate([[start], inside])
            uniform = True
            if len(grid) > 1:
                intervals = np.diff(grid)
                mean = intervals.mean()
                if mean > 0:
                    uniform = (intervals.std() / mean) < uniformity_threshold
            measures.append({
                "start": float(start),
                "raw_beats": len(grid),
                "duration": float(end - start),
                "uniform": bool(uniform),
            })
        return measures

    @staticmethod
    def _global_time_signature(measures: List[Dict]) -> int:
        counts = [m["raw_beats"] for m in measures if m.get("uniform", True)]
        if len(counts) < 10:
            return 4
        mode_val = Counter(counts).most_common(1)[0][0]
        return 4 if mode_val == 2 else int(mode_val)

    @staticmethod
    def _stable_regions(
        measures: List[Dict], window: int = 4, threshold: float = 0.1
    ) -> List:
        """(start_idx, end_idx) spans of consistent measure duration."""
        starts = np.asarray([m["start"] for m in measures])
        regions = []
        i = 0
        while i <= len(measures) - window:
            intervals = np.diff(starts[i:i + window])
            if intervals.size == 0 or intervals.std() >= threshold:
                i += 1
                continue
            ideal = float(intervals.mean())
            end = i + window - 1
            j = end
            while j + 1 < len(measures):
                if abs(starts[j + 1] - (starts[j] + ideal)) < threshold:
                    end = j + 1
                    j += 1
                else:
                    break
            regions.append((i, end))
            i = end + 1
        return regions

    @staticmethod
    def _patch_gaps_and_merge(
        regions: List[Dict], tolerance: float = 0.25
    ) -> List[Dict]:
        if len(regions) >= 2:
            patched = []
            current = regions[0]
            for nxt in regions[1:]:
                patched.append(current)
                last_db = current["downbeats"][-1]
                dur = current["avg_duration"]
                end_ts = last_db + dur
                gap = nxt["downbeats"][0] - end_ts
                if dur > 0 and gap >= 0:
                    ratio = gap / dur
                    full, half = 0, False
                    if abs(ratio - round(ratio)) < tolerance and round(ratio) >= 1:
                        full = round(ratio)
                    elif abs(ratio - (math.floor(ratio) + 0.5)) < tolerance:
                        full, half = math.floor(ratio), True
                    ts = end_ts
                    for _ in range(full):
                        patched.append({
                            "time_sig": current["time_sig"],
                            "bpm": current["bpm"],
                            "start_time": ts,
                            "downbeats": [ts],
                            "avg_duration": dur,
                        })
                        ts += dur
                    if half:
                        patched.append({
                            "time_sig": 2,
                            "bpm": current["bpm"],
                            "start_time": ts,
                            "downbeats": [ts],
                            "avg_duration": dur / 2,
                        })
                current = nxt
            patched.append(current)
        else:
            patched = list(regions)

        merged: List[Dict] = []
        for region in patched:
            if (
                merged
                and merged[-1]["time_sig"] == region["time_sig"]
                and abs(merged[-1]["bpm"] - region["bpm"]) < 1.0
            ):
                merged[-1]["downbeats"] = list(merged[-1]["downbeats"]) + list(
                    region["downbeats"]
                )
            else:
                merged.append(dict(region))
        return merged
