"""Separator validation on pseudo-pop mixtures (JAX counterpart:
scripts/eval_separator_pseudopop.py).

  held-out corpus MIDI (eval split, snap-gated grid)
    → five audio stems: formant-vocal lead (top line +12), the piano cover
      itself, a sustained chord pad ('guitar' slot), a bass root line, and
      synthetic drums riding the song's known beat grid (data/pseudopop.py)
    → time-domain mix at 44.1 kHz (int16-quantized, the serving chain)
    → the separator → per-stem mel-magnitude SI-SDR against the isolated
      stems' own mel transforms, beside the raw mix as every stem's estimate
    → downstream: beat F on the mixture through the separator and through
      the bypass, against the known grid (the Beat-Transformer runs the
      dilated-attention kernel).

SI-SDR (scale-invariant, mel-magnitude domain) is used because the
separator's output is ratio-masked mix power, whose absolute scale is not
comparable to an isolated stem render.

    python -m etude_tpu_torch.scripts.eval_separator_pseudopop [--songs 8] \\
        [--seconds 60] [--corpus DIR] [--out summary.json] \\
        [--separator-model DIR] [--beat-model DIR] [--device cpu]

Prints the summary as one JSON line (and writes it to `--out`).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from ..config import PathConfig
from . import refuse_checkpoints
from .validate_beat_corpus import grid_beat_times, snap_gated_song
from ..data.corpus_render import CORPUS_ROOT
from ..data.pseudopop import STEM_NAMES, build_stems as _build_stems
from ..data.synthetic import beat_f_measure
from ..utils.logger import logger


def build_stems(notes, tempo, dur: float, sr: int, seed: int):
    beats = grid_beat_times(tempo, dur)
    downs = np.asarray(
        [t for r in tempo for t in r["downbeats"] if t < dur], float)
    return _build_stems(notes, beats, downs, dur, sr, seed)


def mel_mag(wave: np.ndarray, device="cpu") -> np.ndarray:
    """[T_true, 128] mel magnitude of a raw wave through the separation
    transform's mix path (data/separation.py `mix_mel`, one stem), computed
    on `device`."""
    from ..data.separation import mix_mel, pad_bucket_wave

    padded, true_frames = pad_bucket_wave(wave)
    with torch.inference_mode():
        power = mix_mel(torch.from_numpy(np.asarray(padded, np.float32)).to(device), 1)[0]
        power = power.float().cpu().numpy()
    return np.sqrt(np.maximum(power, 0.0))[:true_frames]


def separated_mel_mag(separator, wave: np.ndarray) -> np.ndarray:
    """[5, T_true, 128] mel magnitude of the separator's stems for a raw
    wave (data/separation.py `separate_mel`, in the separator's dtype)."""
    from ..data.separation import pad_bucket_wave, separate_mel

    padded, true_frames = pad_bucket_wave(wave)
    with torch.inference_mode():
        power = separate_mel(separator.model,
                             torch.from_numpy(np.asarray(padded, np.float32)).to(
                                 separator.device),
                             true_frames, separator.compute_dtype)
        power = power.float().cpu().numpy()[:, :true_frames]
    return np.sqrt(np.maximum(power, 0.0))


def si_sdr(est: np.ndarray, ref: np.ndarray, eps: float = 1e-8) -> float:
    """Scale-invariant SDR (dB) between flattened nonneg magnitude grids."""
    e, r = est.ravel().astype(np.float64), ref.ravel().astype(np.float64)
    alpha = float(np.dot(e, r) / max(np.dot(r, r), eps))
    num = np.sum((alpha * r) ** 2)
    den = np.sum((e - alpha * r) ** 2)
    return float(10.0 * np.log10((num + eps) / (den + eps)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Separator SI-SDR on pseudo-pop mixes")
    parser.add_argument("--songs", type=int, default=8)
    parser.add_argument("--seconds", type=float, default=60.0)
    parser.add_argument("--snap-gate", type=float, default=0.02)
    parser.add_argument("--corpus", default=str(CORPUS_ROOT))
    parser.add_argument("--sr", type=int, default=44100)
    parser.add_argument("--out", default=None, help="write JSON summary here")
    parser.add_argument("--separator-model", default=str(PathConfig().separator_model),
                        help="separator export (params-only)")
    parser.add_argument("--beat-model", default=str(PathConfig().beat_detector_model),
                        help="beat model export (params-only)")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    out = refuse_checkpoints(args.out, "--out") if args.out else None

    from ..config import BeatDetectorConfig
    from ..data.beat_detector import BeatDetector
    from ..data.corpus_render import corpus_song_dirs, split_songs
    from ..data.separation import SourceSeparator

    separator = SourceSeparator(model_path=args.separator_model, device=args.device,
                                allow_random_weights=True)
    bypass = SourceSeparator(bypass=True, device=args.device)
    detector = BeatDetector(BeatDetectorConfig(), model_path=args.beat_model,
                            device=args.device, allow_random_weights=True)

    _, eval_dirs = split_songs(corpus_song_dirs(Path(args.corpus)))
    rows = []
    for d in eval_dirs:
        if len(rows) >= args.songs:
            break
        gated = snap_gated_song(d / "etude_d.mid", args.seconds,
                                args.snap_gate)
        if gated is None:
            continue
        notes, tempo, _snap = gated
        dur = min(max(n["offset"] for n in notes) + 0.5, args.seconds)
        mix, stems, beats = build_stems(notes, tempo, dur, args.sr,
                                        seed=len(rows))

        est_mag = separated_mel_mag(separator, mix)
        sdrs = {}
        for si, name in enumerate(STEM_NAMES):
            ref = mel_mag(stems[name], separator.device)
            sdrs[name] = round(si_sdr(est_mag[si], ref), 2)
        # Baseline every stem estimator must beat: the raw mix in the slot.
        mix_mag_grid = mel_mag(mix, separator.device)
        base = {name: round(si_sdr(mix_mag_grid, mel_mag(stems[name], separator.device)), 2)
                for name in STEM_NAMES}

        # Downstream: beat F with separation vs bypass.
        f_by_path = {}
        for label, sep in (("sep", separator), ("bypass", bypass)):
            feats = sep.separate_features(None, wave_sr=(mix, args.sr),
                                          return_device=True)
            pred = detector.detect(feats, cleanup_input=False)
            est_beats = np.asarray(pred["beat_pred"], float)
            f_by_path[label] = round(beat_f_measure(est_beats, beats), 4)

        row = {"song": d.name, "dur_s": round(dur, 1), "si_sdr": sdrs,
               "si_sdr_mix_baseline": base,
               "beat_f_sep": f_by_path["sep"],
               "beat_f_bypass": f_by_path["bypass"]}
        rows.append(row)
        logger.info(
            f"{d.name}: SI-SDR " +
            " ".join(f"{k}={sdrs[k]:+.1f}" for k in STEM_NAMES) +
            f" | beat F sep {row['beat_f_sep']:.3f} "
            f"vs bypass {row['beat_f_bypass']:.3f}")

    if not rows:
        logger.error("no snap-gated eval songs")
        return 1
    summary = {
        "songs": rows,
        "mean_si_sdr": {
            k: round(float(np.mean([r["si_sdr"][k] for r in rows])), 2)
            for k in STEM_NAMES},
        "mean_si_sdr_mix_baseline": {
            k: round(float(np.mean([r["si_sdr_mix_baseline"][k]
                                    for r in rows])), 2)
            for k in STEM_NAMES},
        "mean_beat_f_sep": round(
            float(np.mean([r["beat_f_sep"] for r in rows])), 4),
        "mean_beat_f_bypass": round(
            float(np.mean([r["beat_f_bypass"] for r in rows])), 4),
    }
    print(json.dumps(summary))
    if out is not None:
        out.write_text(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
