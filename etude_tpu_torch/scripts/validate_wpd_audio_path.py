"""WPD through the aligner's audio path on corpus songs, against the
corpus's cached warping paths (JAX counterpart:
scripts/validate_wpd_audio_path.py).

    python -m etude_tpu_torch.scripts.validate_wpd_audio_path [--songs 6] \\
        [--seconds S] [--corpus DIR] [--device cpu]

The corpus (`docs/songs`) ships per-song `wp.json` warping paths that the
reference computed from the real origin and cover recordings, not the
audio. This script runs the aligner's whole audio path (tuning estimate →
chroma and onset features → key-shift search → DTW, the multi-resolution
banded DTW above `_FULL_DTW_MAX_CELLS`) on renders of the two corpus MIDI
versions that live on those two timelines:

    origin proxy = render(etude_e.mid)   the extractor's notes, origin timeline
    cover        = render(human.mid)     the human performance, cover timeline

and compares its WPD with the cached path's. Renders and real mixes are
different signals, so what must hold is agreement within the WPD scale that
separates corpus versions (about 0.1). One JSON line goes to stdout. The
features and the full DTW's wavefront run on `--device`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from ..data.corpus_render import CORPUS_ROOT, corpus_song_dirs
from ..utils.device import resolve_device


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="WPD through the audio path vs wp.json")
    parser.add_argument("--songs", type=int, default=6)
    parser.add_argument("--seconds", type=float, default=None,
                        help="truncate songs for speed; default full length")
    parser.add_argument("--corpus", default=str(CORPUS_ROOT))
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    from ..data.aligner import AudioAligner
    from ..data.synthetic import render_piano
    from ..evaluation.metrics import WPDCalculator
    from ..utils.logger import logger
    from ..utils.midi import read_midi_notes

    aligner = AudioAligner(device=resolve_device(args.device))
    wpd = WPDCalculator()
    rows = []
    for d in corpus_song_dirs(Path(args.corpus)):
        if len(rows) >= args.songs:
            break
        if not (d / "etude_e.mid").exists() or not (d / "wp.json").exists():
            continue
        cached = aligner._load_from_cache(d, "human")
        if cached is None:
            continue
        cached_wpd = wpd.calculate(cached).get("wpd_score")
        if cached_wpd is None:
            continue

        origin_notes = read_midi_notes(d / "etude_e.mid")
        cover_notes = read_midi_notes(d / "human.mid")
        if args.seconds:
            origin_notes = [n for n in origin_notes if n["onset"] < args.seconds]
            cover_notes = [n for n in cover_notes if n["onset"] < args.seconds]
        dur_o = max(n["offset"] for n in origin_notes) + 0.5
        dur_c = max(n["offset"] for n in cover_notes) + 0.5

        t0 = time.time()
        origin = render_piano(origin_notes, dur_o, sr=aligner.fs)
        cover = render_piano(cover_notes, dur_c, sr=aligner.fs)
        render_s = time.time() - t0

        t0 = time.time()
        result = aligner.compute_warping_path(origin, cover)
        align_s = time.time() - t0
        audio_wpd = wpd.calculate(result).get("wpd_score")

        rows.append({
            "song": d.name,
            "wpd_audio_path": None if audio_wpd is None else round(audio_wpd, 4),
            "wpd_cached": round(cached_wpd, 4),
            "delta": None if audio_wpd is None else round(abs(audio_wpd - cached_wpd), 4),
            "pitch_shift": result.get("pitch_shift"),
            "origin_seconds": round(dur_o, 1),
            "align_seconds": round(align_s, 1),
            "render_seconds": round(render_s, 1),
        })
        logger.info(f"{d.name}: audio-path WPD {audio_wpd} vs cached {cached_wpd} "
                    f"(align {align_s:.0f}s)")

    deltas = [r["delta"] for r in rows if r["delta"] is not None]
    summary = {
        "songs": rows,
        "mean_abs_delta": round(float(np.mean(deltas)), 4) if deltas else None,
        "max_abs_delta": round(float(np.max(deltas)), 4) if deltas else None,
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
