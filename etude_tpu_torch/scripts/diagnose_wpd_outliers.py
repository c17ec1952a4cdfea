"""Where an audio-path warping path leaves the corpus's cached one, and
whether the origin proxy or the features are the cause (JAX counterpart:
scripts/diagnose_wpd_outliers.py, whose docstring gives the history).

    python -m etude_tpu_torch.scripts.diagnose_wpd_outliers \\
        [--songs CPOP07 CPOP09 CPOP01] [--ablate-song CPOP07] \\
        [--out outputs/wpd_outliers.json] [--corpus DIR] [--device cpu]

1. Localize: both mappings t_cover → t_origin (the cached path and the
   aligner's path from renders, `AudioAligner.compute_warping_path`) on a
   common 0.5 s cover-time grid (`compare_paths`): the share of the grid off
   by more than 1 s, the worst contiguous region, the median by quarter. A
   structural failure shows as one region, a weak signal as broad drift.
2. Proxy ablation: the origin proxy render(etude_e.mid) against
   render(etude_d.mid), the decoder's cover on the same origin timeline.
3. Feature ablations on `--ablate-song` with the etude_e proxy
   (`align_with`): the DLNCO weight alpha at 0.2 and 0.8, and no tuning
   estimate.

The report goes to `--out` and to stdout as one JSON line. The features and
the full DTW's wavefront run on `--device` (the banded refinement above
`_FULL_DTW_MAX_CELLS` on the host). The JAX script writes
`validation/wpd_outliers.json`; the port writes under `outputs/` and
refuses `dataset_distill/`, `validation/` and `checkpoints/`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from . import OUTPUTS, refuse_committed
from ..data.corpus_render import CORPUS_ROOT
from ..utils.device import resolve_device

FEATURE_RATE = 50


def mapping_on_grid(wp: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """t_cover → t_origin interpolated on `grid` (seconds)."""
    t_cover = wp[0] / FEATURE_RATE
    t_origin = wp[1] / FEATURE_RATE
    order = np.argsort(t_cover, kind="stable")
    return np.interp(grid, t_cover[order], t_origin[order])


def compare_paths(wp_a: np.ndarray, wp_b: np.ndarray) -> dict:
    """Localized disagreement between two cover→origin mappings."""
    t_end = min(wp_a[0].max(), wp_b[0].max()) / FEATURE_RATE
    grid = np.arange(0.0, t_end, 0.5)
    if len(grid) < 8:
        return {"error": "paths too short to compare"}
    diff = mapping_on_grid(wp_a, grid) - mapping_on_grid(wp_b, grid)
    absd = np.abs(diff)
    # The worst contiguous region where |diff| > 1 s.
    bad = absd > 1.0
    worst = {"start_s": None, "end_s": None}
    if bad.any():
        edges = np.flatnonzero(np.diff(np.concatenate(([0], bad.view(np.int8), [0]))))
        runs = edges.reshape(-1, 2)
        longest = runs[np.argmax(runs[:, 1] - runs[:, 0])]
        worst = {"start_s": round(float(grid[longest[0]]), 1),
                 "end_s": round(float(grid[min(longest[1], len(grid) - 1)]), 1)}
    quarters = [round(float(np.median(q)), 2) for q in np.array_split(absd, 4)]
    return {
        "frac_off_gt1s": round(float(bad.mean()), 3),
        "median_abs_s": round(float(np.median(absd)), 2),
        "max_abs_s": round(float(absd.max()), 2),
        "worst_region": worst,
        "median_abs_by_quarter_s": quarters,
    }


def align_with(origin: np.ndarray, cover: np.ndarray, fs: int,
               alpha: float = 0.5, use_tuning: bool = True, device=None) -> dict:
    """AudioAligner.compute_warping_path with alpha and the tuning estimate
    exposed."""
    from ..data.aligner import _FULL_DTW_MAX_CELLS
    from ..ops.chroma import chroma_features, estimate_tuning, optimal_chroma_shift
    from ..ops.dtw import dtw_path, mrms_dtw_path

    tc = estimate_tuning(cover, fs) if use_tuning else 0.0
    to = estimate_tuning(origin, fs) if use_tuning else 0.0
    chroma_c, onset_c = chroma_features(cover, fs, FEATURE_RATE, tc, device=device)
    chroma_o, onset_o = chroma_features(origin, fs, FEATURE_RATE, to, device=device)
    shift = optimal_chroma_shift(chroma_c, chroma_o)
    chroma_o = np.roll(chroma_o, shift, axis=1)
    onset_o = np.roll(onset_o, shift, axis=1)
    fn = (mrms_dtw_path
          if chroma_c.shape[0] * chroma_o.shape[0] > _FULL_DTW_MAX_CELLS
          else dtw_path)
    wp = fn(chroma_c, onset_c, chroma_o, onset_o, alpha=alpha, device=device)
    return {"wp": wp.astype(int), "pitch_shift": int((-shift % 12 + 6) % 12 - 6),
            "num_frames_cover": chroma_c.shape[0],
            "num_frames_origin": chroma_o.shape[0]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Root-cause audio-path WPD outliers")
    parser.add_argument("--songs", nargs="+", default=["CPOP07", "CPOP09", "CPOP01"])
    parser.add_argument("--ablate-song", default="CPOP07")
    parser.add_argument("--out", default=str(OUTPUTS / "wpd_outliers.json"))
    parser.add_argument("--corpus", default=str(CORPUS_ROOT))
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    from ..data.aligner import AudioAligner
    from ..data.synthetic import render_piano
    from ..evaluation.metrics import WPDCalculator
    from ..utils.logger import logger
    from ..utils.midi import read_midi_notes

    out = refuse_committed(args.out, "--out")
    device = resolve_device(args.device)
    corpus = Path(args.corpus)
    aligner = AudioAligner(device=device)
    wpd = WPDCalculator()
    report = {"songs": {}, "ablations": {}}

    for name in args.songs:
        d = corpus / name
        cached = aligner._load_from_cache(d, "human")
        cached_wpd = wpd.calculate(cached)["wpd_score"]
        cover_notes = read_midi_notes(d / "human.mid")
        dur_c = max(n["offset"] for n in cover_notes) + 0.5
        cover = render_piano(cover_notes, dur_c, sr=aligner.fs)
        row = {"wpd_cached": round(cached_wpd, 3), "proxies": {}}
        for proxy in ("etude_e", "etude_d"):
            t0 = time.time()
            o_notes = read_midi_notes(d / f"{proxy}.mid")
            origin = render_piano(o_notes, max(n["offset"] for n in o_notes) + 0.5,
                                  sr=aligner.fs)
            res = aligner.compute_warping_path(origin, cover)
            score = wpd.calculate(res)["wpd_score"]
            row["proxies"][proxy] = {
                "wpd": round(score, 3),
                "delta_vs_cached": round(abs(score - cached_wpd), 3),
                "pitch_shift": res["pitch_shift"],
                "vs_cached_path": compare_paths(res["wp"], cached["wp"]),
                "align_seconds": round(time.time() - t0, 1),
            }
            logger.info(f"{name}/{proxy}: WPD {score:.3f} (cached {cached_wpd:.3f}) "
                        f"off>1s {row['proxies'][proxy]['vs_cached_path'].get('frac_off_gt1s')}")
        report["songs"][name] = row

    # Feature ablations on the worst song, etude_e proxy.
    d = corpus / args.ablate_song
    cached = aligner._load_from_cache(d, "human")
    cached_wpd = wpd.calculate(cached)["wpd_score"]
    cover_notes = read_midi_notes(d / "human.mid")
    cover = render_piano(cover_notes, max(n["offset"] for n in cover_notes) + 0.5,
                         sr=aligner.fs)
    o_notes = read_midi_notes(d / "etude_e.mid")
    origin = render_piano(o_notes, max(n["offset"] for n in o_notes) + 0.5, sr=aligner.fs)
    for label, kw in [("alpha=0.2", {"alpha": 0.2}),
                      ("alpha=0.8", {"alpha": 0.8}),
                      ("no_tuning", {"use_tuning": False})]:
        res = align_with(origin, cover, aligner.fs, device=device, **kw)
        score = wpd.calculate(res)["wpd_score"]
        report["ablations"][label] = {
            "song": args.ablate_song, "wpd": round(score, 3),
            "delta_vs_cached": round(abs(score - cached_wpd), 3),
            "vs_cached_path": compare_paths(res["wp"], cached["wp"]),
        }
        logger.info(f"ablation {label}: WPD {score:.3f} vs cached {cached_wpd:.3f}")

    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
