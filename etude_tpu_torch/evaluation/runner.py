"""Evaluation runner (JAX counterpart: etude_tpu/evaluation/runner.py).

Iterates the evaluation corpus (metadata.json listing song directories) ×
versions, computing WPD (audio alignment on the device, cache-first via
wp.json), RGC and IPE per rendered MIDI/JSON. Returns the rows
{song, version, wpd, rgc, ipe} as dicts, a score None where the JAX
package's DataFrame holds NaN; `write_csv` writes them as that DataFrame's
`to_csv(index=False)` does, with the standard library.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

from ..config import EtudeConfig
from ..data.aligner import AudioAligner
from ..utils.logger import logger
from ..utils.profiling import maybe_span
from .metrics import IPECalculator, RGCCalculator, WPDCalculator

Row = Dict[str, Union[str, float, None]]


class EvaluationRunner:
    def __init__(self, config: EtudeConfig, device=None):
        """The aligner of WPD runs on CUDA unless `device` is the CPU."""
        self.config = config
        self.eval_dir = Path(config.eval.eval_dir)
        self.metadata_path = Path(config.eval.metadata_path)
        self.versions = dict(config.eval.versions)
        m = config.eval.metrics
        self.wpd = WPDCalculator(
            subsample_step=m.wpd_subsample_step, trim_seconds=m.wpd_trim_seconds
        )
        self.rgc = RGCCalculator(top_k=m.rgc_top_k)
        self.ipe = IPECalculator(n_gram=m.ipe_n_gram, n_clusters=m.ipe_n_clusters)
        self.aligner = AudioAligner(device=device)

    def _load_metadata(self) -> List[Dict]:
        if not self.metadata_path.exists():
            logger.error(f"metadata not found: {self.metadata_path}")
            return []
        with open(self.metadata_path, "r", encoding="utf-8") as f:
            return json.load(f)

    def run(
        self,
        versions: Optional[Sequence[str]] = None,
        metrics: Sequence[str] = ("wpd", "rgc", "ipe"),
        timer=None,
    ) -> List[Row]:
        """`timer` (a StageTimer) gets a span per song, "evaluate <song>"."""
        songs = self._load_metadata()
        versions = list(versions) if versions else list(self.versions.keys())
        rows = []

        for meta in songs:
            # Reference metadata.json entries use "dir_name" (docs/songs).
            song_id = (meta.get("dir_name") or meta.get("id")
                       or meta.get("song_id") or meta.get("name"))
            song_dir = self.eval_dir / str(song_id)
            if not song_dir.exists():
                continue
            with maybe_span(timer, f"evaluate {song_id}"):
                for version in versions:
                    row = {"song": str(song_id), "version": version}
                    if "wpd" in metrics:
                        row["wpd"] = self._compute_wpd(song_dir, version)
                    for name, calc in (("rgc", self.rgc), ("ipe", self.ipe)):
                        if name not in metrics:
                            continue
                        row[name] = self._compute_notes_metric(song_dir, version, calc,
                                                               f"{name}_score")
                    rows.append(row)
        return rows

    # ---- per-metric helpers -------------------------------------------
    def _compute_wpd(self, song_dir: Path, version: str) -> Optional[float]:
        origin = song_dir / "origin.wav"
        cover_audio = song_dir / f"{version}.wav"
        try:
            align = self.aligner.align(origin, cover_audio, song_dir)
            if align is None:
                # Cache-only fallback: the reference corpus ships wp.json.
                align = self.aligner._load_from_cache(song_dir, version)
            if align is None:
                return None
            result = self.wpd.calculate(align)
            return result.get("wpd_score")
        except Exception as exc:
            logger.debug(f"WPD failed for {song_dir.name}/{version}: {exc}")
            return None

    def _compute_notes_metric(self, song_dir: Path, version: str, calc,
                              key: str) -> Optional[float]:
        for suffix in (".mid", ".json"):
            path = song_dir / f"{version}{suffix}"
            if path.exists():
                result = calc.calculate(path)
                if key in result:
                    return result[key]
                logger.debug(
                    f"{key} failed for {song_dir.name}/{version}: "
                    f"{result.get('error')}"
                )
                return None
        return None


def columns(rows: Sequence[Row]) -> List[str]:
    """The keys of the rows in order of first appearance (a DataFrame's
    columns)."""
    return list(dict.fromkeys(k for row in rows for k in row))


def write_csv(rows: Sequence[Row], path: Union[str, Path]) -> None:
    """The rows as `pd.DataFrame(rows).to_csv(path, index=False)` writes
    them: a missing or None score is an empty cell, a float its shortest
    round-trip repr."""
    cols = columns(rows)
    with open(path, "w", encoding="utf-8", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(cols)
        for row in rows:
            writer.writerow(["" if row.get(c) is None else row[c] for c in cols])
