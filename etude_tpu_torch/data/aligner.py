"""Audio-to-audio alignment, origin ↔ cover (JAX counterpart:
etude_tpu/data/aligner.py).

Tuning estimation, chroma + onset features, optimal cyclic chroma (key)
shift, DTW warping path, pitch-shift bookkeeping, and the per-song wp.json
cache ({version_key: {wp, pitch_shift, num_frames_cover,
num_frames_origin}}) that prepare stage 3 and WPD evaluation read; either
package reads the other's file. The features and the full DTW's wavefront
run on the device (ops/chroma.py, ops/dtw.py); the tuning estimate, the key
search and the banded refinement run on the host.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np

from ..ops.chroma import (
    ALIGN_FEATURE_RATE,
    ALIGN_SR,
    chroma_features,
    estimate_tuning,
    optimal_chroma_shift,
)
from ..ops.dtw import dtw_path, mrms_dtw_path
from ..utils.audio import decode_audio
from ..utils.device import resolve_device
from ..utils.logger import logger
from ..utils.profiling import maybe_span

# Above this many cost-matrix cells, use the multi-resolution banded DTW
# (O(N·band) memory) instead of the full matrix: 4 M cells ≈ 16 MB f32 —
# full DTW below, MrMsDTW above (two 4-minute songs at 50 Hz are ~144 M
# cells ≈ 576 MB full vs ~6 MB banded).
_FULL_DTW_MAX_CELLS = 4_000_000


class AudioAligner:
    def __init__(self, fs: int = ALIGN_SR, feature_rate: int = ALIGN_FEATURE_RATE,
                 device=None):
        """Runs on CUDA unless `device` is the CPU."""
        self.fs = fs
        self.feature_rate = feature_rate
        self.device = resolve_device(device)

    def align(
        self,
        origin_audio_path: Union[str, Path],
        cover_audio_path: Union[str, Path],
        song_dir: Union[str, Path],
        timer=None,
    ) -> Optional[Dict]:
        """Cache-first alignment; computes from audio on cache miss."""
        version_key = Path(cover_audio_path).stem
        cached = self._load_from_cache(song_dir, version_key)
        if cached is not None:
            return cached

        if not Path(origin_audio_path).exists() or not Path(cover_audio_path).exists():
            return None
        try:
            with maybe_span(timer, "align: audio decode"):
                origin, _ = decode_audio(origin_audio_path, target_sr=self.fs)
                cover, _ = decode_audio(cover_audio_path, target_sr=self.fs)
        except Exception as exc:
            logger.warn(f"failed to load audio for alignment: {exc}")
            return None

        result = self.compute_warping_path(origin, cover, timer=timer)
        self._save_to_cache(song_dir, version_key, result)
        return result

    def compute_warping_path(
        self, origin: np.ndarray, cover: np.ndarray, timer=None
    ) -> Dict:
        """`timer` (a StageTimer) gets a span per step: tuning, chroma, shift
        search, then the wavefront (or the coarse wavefront and the banded
        DP)."""
        with maybe_span(timer, "align: tuning"):
            tuning_cover = estimate_tuning(cover, self.fs)
            tuning_origin = estimate_tuning(origin, self.fs)

        with maybe_span(timer, "align: chroma"):
            chroma_cover, onset_cover = chroma_features(
                cover, self.fs, self.feature_rate, tuning_cover, device=self.device
            )
            chroma_origin, onset_origin = chroma_features(
                origin, self.fs, self.feature_rate, tuning_origin, device=self.device
            )

        with maybe_span(timer, "align: shift search"):
            shift = optimal_chroma_shift(chroma_cover, chroma_origin)
        chroma_origin_s = np.roll(chroma_origin, shift, axis=1)
        onset_origin_s = np.roll(onset_origin, shift, axis=1)

        n_cells = chroma_cover.shape[0] * chroma_origin_s.shape[0]
        if n_cells > _FULL_DTW_MAX_CELLS:
            logger.debug(
                f"alignment: {n_cells / 1e6:.0f}M cells → multi-resolution "
                "banded DTW"
            )
            wp = mrms_dtw_path(
                chroma_cover, onset_cover, chroma_origin_s, onset_origin_s,
                alpha=0.5, device=self.device, timer=timer,
            )
        else:
            with maybe_span(timer, "align: wavefront"):
                wp = dtw_path(
                    chroma_cover, onset_cover, chroma_origin_s, onset_origin_s,
                    alpha=0.5, device=self.device,
                )

        pitch_shift = -shift % 12
        if pitch_shift > 6:
            pitch_shift -= 12

        return {
            "wp": wp.astype(int),
            "pitch_shift": int(pitch_shift),
            "num_frames_cover": chroma_cover.shape[0],
            "num_frames_origin": chroma_origin.shape[0],
        }

    # ---- wp.json cache (reference contract) ---------------------------
    def _load_from_cache(
        self, song_dir: Union[str, Path], version_key: str
    ) -> Optional[Dict]:
        cache_path = Path(song_dir) / "wp.json"
        if not cache_path.exists():
            return None
        try:
            with open(cache_path, "r", encoding="utf-8") as f:
                all_data = json.load(f)
            entry = all_data.get(version_key)
            required = ("wp", "num_frames_cover", "num_frames_origin")
            if isinstance(entry, dict) and all(k in entry for k in required):
                entry = dict(entry)
                entry["wp"] = np.asarray(entry["wp"], dtype=int)
                entry.setdefault("pitch_shift", 0)
                return entry
        except (json.JSONDecodeError, KeyError, TypeError):
            pass
        return None

    def _save_to_cache(
        self, song_dir: Union[str, Path], version_key: str, result: Dict
    ) -> None:
        cache_path = Path(song_dir) / "wp.json"
        cache_path.parent.mkdir(parents=True, exist_ok=True)
        all_data = {}
        if cache_path.exists():
            try:
                with open(cache_path, "r", encoding="utf-8") as f:
                    all_data = json.load(f)
            except json.JSONDecodeError:
                pass
        entry = dict(result)
        entry["wp"] = np.asarray(result["wp"]).tolist()
        all_data[version_key] = entry
        with open(cache_path, "w", encoding="utf-8") as f:
            json.dump(all_data, f, indent=4)
        logger.debug(f"alignment cached for '{version_key}' → {cache_path}")
