"""Shared metric utilities (JAX counterpart:
etude_tpu/evaluation/metrics/base_metric.py, of which this is the port's own
copy)."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ...utils.midi import read_midi_notes


def get_onsets_from_file(file_path: Path) -> np.ndarray:
    """Unique sorted note onsets from a .mid (non-drum) or note-JSON file."""
    file_path = Path(file_path)
    if not file_path.exists():
        return np.array([])
    try:
        if file_path.suffix.lower() == ".mid":
            onsets = [n["onset"] for n in read_midi_notes(file_path)]
        elif file_path.suffix.lower() == ".json":
            with open(file_path, "r", encoding="utf-8") as f:
                notes = json.load(f)
            onsets = [n["onset"] for n in notes] if notes else []
        else:
            return np.array([])
        if len(onsets) < 2:
            return np.array([])
        return np.unique(onsets)
    except Exception:
        return np.array([])
