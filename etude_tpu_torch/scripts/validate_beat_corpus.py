"""Beat-tracking F-measure on rendered corpus music (JAX counterpart:
scripts/validate_beat_corpus.py).

Measures the full structuralize chain — render → separation features →
Beat-Transformer (the dilated-attention kernel) → DBN — on corpus songs,
using etude_d.mid: the reference decoder's output is quantized to a beat
grid by construction, so when its onsets snap tightly to an inferred
constant-tempo grid (mean snap deviation under --snap-gate seconds), that
grid's beat times are trustworthy ground truth for the rendered audio.

    python -m etude_tpu_torch.scripts.validate_beat_corpus [--songs 10] \\
        [--seconds 180] [--corpus DIR] [--held-out-only] [--no-separator] \\
        [--octave-disambiguation] [--separator-model DIR] [--beat-model DIR] \\
        [--device cpu]

Prints the summary as one JSON line: per song `beat_f` and the
octave-tolerant `beat_f_octave` (the best of the grid, half and double
time), their means and the number of songs the snap gate left out.
`validate` is also the held-out evaluation of `train_aux beat-corpus` and
`beat --scenes-dir`. Each song's render goes to a temporary directory of its
own (the JAX script writes a fixed file), so parallel runs do not collide.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from ..config import PathConfig
from .distill_dataset import estimate_tempo_grid, grid_fit_score
from ..data.corpus_render import CORPUS_ROOT
from ..data.synthetic import beat_f_measure, render_piano
from ..utils.audio import save_wav
from ..utils.logger import logger
from ..utils.midi import read_midi_notes


def grid_beat_times(tempo, horizon: float) -> np.ndarray:
    beats = []
    for region in tempo:
        beat = 60.0 / region["bpm"]
        downbeats = list(region["downbeats"])
        if not downbeats:
            continue
        end = downbeats[-1] + beat * region["time_sig"]
        t = downbeats[0]
        while t < min(end, horizon):
            beats.append(t)
            t += beat
    return np.asarray(beats)


def snap_gated_song(mid: Path, seconds: float, snap_gate: float):
    """MIDI → (notes, tempo grid, snap deviation) when the song's onsets snap
    to a constant grid tightly enough for that grid to serve as beat ground
    truth; None otherwise."""
    if not mid.exists():
        return None
    notes = [n for n in read_midi_notes(mid) if n["onset"] < seconds]
    if len(notes) < 64:
        return None
    tempo = estimate_tempo_grid(notes)
    snap = grid_fit_score(notes, tempo) if tempo else np.inf
    if not np.isfinite(snap) or snap > snap_gate:
        return None
    return notes, tempo, float(snap)


def score_song(separator, detector, notes, tempo, wav: Optional[Path] = None):
    """Render → serving features → beat forward → DBN → F vs grid beats.

    The render is written to `wav`, or into a temporary directory of the
    call's own. Returns the row dict, or None when the grid is too short."""
    horizon = max(n["offset"] for n in notes)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(wav) if wav is not None else Path(tmp) / "beat_validate.wav"
        save_wav(path, render_piano(notes, horizon + 1.0, sr=44100), 44100)
        features = separator.separate_features(path, return_device=True)
    pred = detector.detect(features, cleanup_input=False)
    est = np.asarray(pred["beat_pred"], float)
    ref = grid_beat_times(tempo, horizon)
    if len(ref) < 8:
        return None
    f = beat_f_measure(est, ref)
    # The DBN may lock to half/double time legitimately; also score the
    # standard double/half-tempo references and report the best (the
    # common "beat F-measure with octave tolerance" diagnostic).
    f_half = beat_f_measure(est, ref[::2])
    ref_dbl = np.sort(np.concatenate([ref, ref[:-1] + np.diff(ref) / 2]))
    f_dbl = beat_f_measure(est, ref_dbl)
    return {
        "beat_f": round(f, 4),
        "beat_f_octave": round(max(f, f_half, f_dbl), 4),
        "n_est": len(est), "n_ref": len(ref),
    }


def validate(separator, detector, song_dirs, n_songs: int, seconds: float,
             snap_gate: float, version: str = "etude_d"):
    rows, skipped = [], 0
    for d in song_dirs:
        if len(rows) >= n_songs:
            break
        gated = snap_gated_song(d / f"{version}.mid", seconds, snap_gate)
        if gated is None:
            skipped += 1
            continue
        notes, tempo, snap = gated
        row = score_song(separator, detector, notes, tempo)
        if row is None:
            continue
        row.update({"song": d.name, "snap_dev_s": round(snap, 4)})
        rows.append(row)
        logger.info(f"{d.name}: beat F {row['beat_f']:.3f} (octave-tolerant "
                    f"{row['beat_f_octave']:.3f}, {row['n_est']} est vs "
                    f"{row['n_ref']} ref beats)")
    return {
        "songs": rows,
        "snap_gated_out": skipped,
        "mean_beat_f": round(float(np.mean([r["beat_f"] for r in rows])), 4)
        if rows else None,
        "mean_beat_f_octave": round(
            float(np.mean([r["beat_f_octave"] for r in rows])), 4
        ) if rows else None,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Beat F on rendered corpus songs")
    parser.add_argument("--songs", type=int, default=10)
    parser.add_argument("--seconds", type=float, default=180.0)
    parser.add_argument("--snap-gate", type=float, default=0.02,
                        help="max mean onset-to-grid deviation (s) for a "
                             "song's grid to count as ground truth")
    parser.add_argument("--corpus", default=str(CORPUS_ROOT))
    parser.add_argument("--held-out-only", action="store_true",
                        help="score only the corpus_render eval split (songs "
                             "never used for fine-tuning)")
    parser.add_argument("--no-separator", action="store_true",
                        help="ablation: tile the raw mix's mel into every "
                             "stem slot instead of separating")
    parser.add_argument("--octave-disambiguation", action="store_true",
                        help="enable the DBN tempo-octave correction pass "
                             "(ops/beat_octave.py)")
    parser.add_argument("--separator-model", default=str(PathConfig().separator_model),
                        help="separator export (params-only)")
    parser.add_argument("--beat-model", default=str(PathConfig().beat_detector_model),
                        help="beat model export (params-only)")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    from ..config import BeatDetectorConfig
    from ..data.beat_detector import BeatDetector
    from ..data.corpus_render import corpus_song_dirs, split_songs
    from ..data.separation import SourceSeparator

    separator = SourceSeparator(model_path=args.separator_model, bypass=args.no_separator,
                                device=args.device, allow_random_weights=True)
    detector = BeatDetector(
        BeatDetectorConfig(octave_disambiguation=args.octave_disambiguation),
        model_path=args.beat_model, device=args.device, allow_random_weights=True)

    dirs = sorted(p for p in Path(args.corpus).iterdir() if p.is_dir())
    if args.held_out_only:
        _, dirs = split_songs(corpus_song_dirs(Path(args.corpus)))
    summary = validate(separator, detector, dirs, args.songs, args.seconds,
                       args.snap_gate)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
