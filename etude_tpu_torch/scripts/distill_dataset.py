"""The decoder's distillation dataset from the reference's rendered corpus
(JAX counterpart: scripts/distill_dataset.py).

    python -m etude_tpu_torch.scripts.distill_dataset [--corpus DIR] \\
        [--out outputs/distill_dataset] [--limit N] [--grid tracker|rgc] \\
        [--transpose K] [--phase-shifts P] [--double-time] \\
        [--separator-model DIR] [--beat-model DIR] [--device cpu]

The corpus (`docs/songs/<SONG>/`, listed by its `metadata.json`) holds
aligned MIDI versions of each song: `etude_e` (the extractor's notes, the
condition side) and `etude_d` (the reference decoder's cover, the target),
on one timeline. Pairing them gives a distillation corpus for the decoder:
src = condition notes, tgt = the reference decoder's cover, tokenized on
the same beat grid. The corpus has no tempo.json, so a grid is estimated
per song, two ways:

  * `--grid tracker` (default): render the target to audio and run the
    structuralize chain, separation features → Beat-Transformer (the
    dilated-attention kernel on a card) → DBN → BeatAnalyzer, from the
    params-only exports `--separator-model` and `--beat-model`; each
    stable region's downbeats are then fit by least squares and the grid's
    phase moved onto the notes (`TrackerGrid`);
  * `--grid rgc`: a constant 4/4 grid from the target's onsets
    (`estimate_tempo_grid`).

The target was generated bar by bar on a grid, so its onsets sit on
sub-beat slots of the true grid: each candidate is scored by how tightly
the onsets snap to its eighth-note slots (`grid_fit_score`) and
`arbitrate_grid` picks one per song (a failed tracker falls back to rgc).
Tracker grids are cached in `<out>/tempo/<SONG>.json`; a cached song runs no
model. Augmented copies: `--transpose K` (src and tgt shifted together by
±1..±K semitones), `--phase-shifts P` (downbeats moved 1..P beats later)
and `--double-time` (every bar split in two); all are exact. The vocabulary
is rebuilt from every event, and song i's pair is written as
`<out>/tokenized/NNNN/NNNN_{src,tgt}.npy`.

The JAX script writes into the repository's `dataset_distill/` by default
and renders to a fixed `/tmp` file; the port writes under `outputs/` by
default, refuses `dataset_distill/`, `validation/` and `checkpoints/`, and
renders into `--out`. `TrackerGrid` builds its models at its first
estimate, so `--grid rgc` and a cached tracker run touch no device. The
three grid helpers are shared with the beat scripts (validate_beat_corpus,
gen_beat_scenes) and `train_aux beat-corpus`, which keep only songs whose
grid they recover within a snap gate.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

import numpy as np

from ..config import PathConfig
from . import OUTPUTS, refuse_committed
from ..data.corpus_render import CORPUS_ROOT
from ..data.tokenizer import TinyREMITokenizer
from ..data.vocab import Vocab
from ..utils.device import resolve_device
from ..utils.logger import logger
from ..utils.midi import read_midi_notes


def estimate_tempo_grid(notes, min_bpm=70.0, max_bpm=180.0):
    """4/4 grid from note onsets: infer the dominant IOI period, scale it by
    powers of two into the BPM range, anchor downbeats at the first onset."""
    onsets = np.unique([n["onset"] for n in notes])
    if len(onsets) < 16:
        return None
    iois = np.diff(onsets)
    counts = Counter(np.round(iois, 2))
    candidates = [v for v, _ in counts.most_common(8) if v >= 0.05]
    if not candidates:
        return None

    best_tau, best_dev = None, np.inf
    arr = np.array(candidates)
    for tau in arr:
        ratios = arr / tau
        dev = float(np.mean(np.abs(ratios - np.round(ratios))))
        if dev < best_dev:
            best_tau, best_dev = float(tau), dev

    beat = best_tau
    lo, hi = 60.0 / max_bpm, 60.0 / min_bpm
    while beat < lo:
        beat *= 2
    while beat > hi:
        beat /= 2
    bpm = 60.0 / beat

    start = float(onsets[0])
    end = float(max(n["offset"] for n in notes))
    bar = 4 * beat
    n_bars = max(int(np.ceil((end - start) / bar)), 1)
    downbeats = [round(start + i * bar, 6) for i in range(n_bars)]
    return [{
        "time_sig": 4,
        "bpm": round(bpm, 4),
        "start": downbeats[0],
        "downbeats": downbeats,
    }]


def grid_slot_times(tempo, horizon: float) -> np.ndarray:
    """All eighth-note slot times implied by a tempo map (the tokenizer's
    sub-beat resolution is eighths of a beat; scoring at beat/8 keeps the
    triplet slots within half a slot of a grid line)."""
    slots = []
    for region in tempo:
        downbeats = list(region["downbeats"])
        if not downbeats:
            continue
        beat = 60.0 / region["bpm"]
        ts = region["time_sig"]
        bar = beat * ts
        downbeats.append(downbeats[-1] + bar)
        for a, b in zip(downbeats[:-1], downbeats[1:]):
            n = max(int(round((b - a) / beat)) * 8, 8)
            slots.append(np.linspace(a, b, n, endpoint=False))
    if not slots:
        return np.zeros(0)
    out = np.concatenate(slots)
    return out[out <= horizon + 1.0]


def grid_fit_score(notes, tempo) -> float:
    """Mean onset distance to the nearest grid slot, in seconds (lower is
    better). A MIDI generated on a grid scores near zero on that grid."""
    onsets = np.unique([n["onset"] for n in notes])
    if len(onsets) == 0 or not tempo:
        return np.inf
    slots = grid_slot_times(tempo, horizon=float(onsets[-1]))
    if len(slots) < 8:
        return np.inf
    idx = np.searchsorted(slots, onsets)
    idx = np.clip(idx, 1, len(slots) - 1)
    d = np.minimum(np.abs(onsets - slots[idx - 1]), np.abs(onsets - slots[idx]))
    return float(d.mean())


class TrackerGrid:
    """Render → separation features → Beat-Transformer → DBN →
    BeatAnalyzer, from params-only exports of the separator and the beat
    model; the models are built at the first estimate (the rgc mode must not
    touch the device). `_stack` holds (separator, detector, analyzer)."""

    def __init__(self, separator_model, beat_model, device="cuda"):
        self.separator_model = separator_model
        self.beat_model = beat_model
        self.device = device
        self._stack = None

    def _build(self):
        from ..config import BeatDetectorConfig
        from ..data.beat_analyzer import BeatAnalyzer
        from ..data.beat_detector import BeatDetector
        from ..data.separation import SourceSeparator

        self._stack = (
            SourceSeparator(model_path=self.separator_model, device=self.device,
                            allow_random_weights=True),
            BeatDetector(BeatDetectorConfig(), model_path=self.beat_model,
                         device=self.device, allow_random_weights=True),
            BeatAnalyzer(),
        )

    def track(self, notes, work_wav: Path):
        """The tracker's regions with each stable region's downbeats refit
        (`_refine_region`), before the phase moves onto the notes."""
        from ..data.synthetic import render_piano
        from ..utils.audio import save_wav

        if self._stack is None:
            self._build()
        separator, detector, analyzer = self._stack
        dur = max(n["offset"] for n in notes) + 1.0
        save_wav(work_wav, render_piano(notes, dur, sr=44100), 44100)
        features = separator.separate_features(work_wav, return_device=True)
        pred = detector.detect(features, cleanup_input=False)
        tempo = analyzer.analyze_predictions(pred["beat_pred"], pred["downbeat_pred"])
        return [self._refine_region(r) for r in tempo]

    def estimate(self, notes, work_wav: Path):
        return self._dephase(self.track(notes, work_wav), notes)

    @staticmethod
    def _dephase(tempo, notes):
        """Remove the audio chain's constant phase bias: STFT windows see
        onset energy up to half a window early, so DBN beat times land a
        few tens of ms before the notes. The median signed deviation of
        note onsets to their nearest eighth-beat slot measures the bias;
        shifting the grid by it keeps the tracker's period, time signature
        and downbeat choice while aligning phase to the material the grid
        will tokenize."""
        if not tempo or not notes:
            return tempo
        onsets = np.unique([n["onset"] for n in notes])
        slots = grid_slot_times(tempo, horizon=float(onsets[-1]))
        if len(slots) < 8:
            return tempo
        idx = np.clip(np.searchsorted(slots, onsets), 1, len(slots) - 1)
        d_lo = onsets - slots[idx - 1]
        d_hi = onsets - slots[idx]
        signed = np.where(np.abs(d_lo) < np.abs(d_hi), d_lo, d_hi)
        shift = float(np.median(signed))
        if not np.isfinite(shift) or abs(shift) > 0.08:
            return tempo
        return [
            dict(r, start=r["start"] + shift,
                 downbeats=[t + shift for t in r["downbeats"]])
            for r in tempo
        ]

    @staticmethod
    def _refine_region(region):
        """Least-squares (phase, bar-period) fit over a stable region's DBN
        downbeats: the tracker's timestamps are quantized to ~23 ms
        activation frames, and within a stable-tempo region the fit removes
        that noise by ~sqrt(n) while keeping the measured phase and time
        signature (which the RGC-period fallback only assumes)."""
        downbeats = np.asarray(region["downbeats"], float)
        if len(downbeats) < 3:
            return region
        i = np.arange(len(downbeats))
        bar, t0 = np.polyfit(i, downbeats, 1)
        if bar <= 0:
            return region
        return {
            "time_sig": region["time_sig"],
            "bpm": 60.0 * region["time_sig"] / bar,
            "start": float(t0),
            "downbeats": (t0 + i * bar).round(6).tolist(),
        }


def arbitrate_grid(tracker_tempo, tracker_score, rgc_tempo, rgc_score):
    """Per-song grid choice shared by the corpus build and the evaluation.
    The snap score is blind to downbeat phase and time signature (any grid
    with the right period snaps), and those are what the tracker measures
    while the RGC fallback assumes 4/4 anchored at the first onset, so the
    tracker wins whenever its snap is in the same league."""
    if tracker_score is None:
        tracker_score = np.inf
    # A non-finite tracker snap must never win: inf <= max(1.5*inf, ...) is
    # True, which would select a degenerate (<8-slot) tracker grid over the
    # fallback whenever both scores are inf.
    if tracker_tempo and np.isfinite(tracker_score) and (
        tracker_score <= max(1.5 * rgc_score, 0.015)
    ):
        return tracker_tempo, "tracker"
    return rgc_tempo, "rgc"


_PIANO_LO, _PIANO_HI = 21, 108


def _transpose_notes(notes, shift: int):
    """Copy of `notes` with pitches shifted; notes leaving the piano range
    are dropped (shift 0 returns the input unchanged)."""
    if shift == 0:
        return notes
    return [
        dict(n, pitch=n["pitch"] + shift)
        for n in notes
        if _PIANO_LO <= n["pitch"] + shift <= _PIANO_HI
    ]


def _phase_shift_tempo(tempo, k_beats: int):
    """Grid variant with every downbeat moved later by k beats: identical
    beat times, different bar segmentation (the music re-windowed). Exact
    by construction (the grid's beat phase is unchanged)."""
    out = []
    for r in tempo:
        beat = 60.0 / r["bpm"]
        out.append(dict(r, downbeats=[d + k_beats * beat
                                      for d in r["downbeats"]]))
    return out


def _double_time_tempo(tempo):
    """Grid variant at double tempo: every bar splits in two (old downbeats
    and bar midpoints), grid slots land on the same absolute times at twice
    the resolution. Teaches the decoder the half/double-time labelings the
    serving beat tracker legitimately produces."""
    out = []
    for r in tempo:
        beat = 60.0 / r["bpm"]
        downs = []
        dbs = list(r["downbeats"])
        for i, d in enumerate(dbs):
            nxt = dbs[i + 1] if i + 1 < len(dbs) else d + r["time_sig"] * beat
            downs.extend([d, (d + nxt) / 2.0])
        out.append(dict(r, bpm=r["bpm"] * 2.0, downbeats=downs))
    return out


def tracker_tempo_cached(tracker: TrackerGrid, name: str, notes, tempo_cache: Path,
                         work_wav: Path):
    """(tracker grid, its snap score) of a song: from `tempo_cache/<name>.json`
    when present, else estimated and cached (a non-finite score stored as
    null, read back as inf)."""
    cache_file = tempo_cache / f"{name}.json"
    if cache_file.exists():
        cached = json.loads(cache_file.read_text())
        tempo, score = cached["tempo"], cached["score"]
    else:
        try:
            tempo = tracker.estimate(notes, work_wav)
        except Exception as exc:
            logger.warn(f"{name}: tracker grid failed: {exc}")
            tempo = []
        score = grid_fit_score(notes, tempo)
        cache_file.write_text(json.dumps(
            {"tempo": tempo, "score": score if np.isfinite(score) else None}
        ))
    return tempo, np.inf if score is None else score


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Build the decoder's distillation corpus")
    parser.add_argument("--corpus", default=str(CORPUS_ROOT))
    parser.add_argument("--out", default=str(OUTPUTS / "distill_dataset"))
    parser.add_argument("--src-version", default="etude_e")
    parser.add_argument("--tgt-version", default="etude_d")
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--grid", choices=["tracker", "rgc"], default="tracker")
    parser.add_argument(
        "--transpose", type=int, default=0, metavar="K",
        help="also emit copies of every pair transposed by ±1..±K semitones "
        "(src and tgt shifted together; timing/attributes are pitch-"
        "invariant, so the augmented pairs are exact)",
    )
    parser.add_argument(
        "--phase-shifts", type=int, default=0, metavar="P",
        help="also emit copies re-barred with downbeats shifted by 1..P "
        "beats (same beat grid, different bar windows — exact)",
    )
    parser.add_argument(
        "--double-time", action="store_true",
        help="also emit copies encoded on the double-tempo grid (same "
        "absolute slot times at 2x resolution — exact; matches the beat "
        "tracker's legitimate octave ambiguity at serving)",
    )
    parser.add_argument("--separator-model", default=str(PathConfig().separator_model),
                        help="separator export (params-only), for --grid tracker")
    parser.add_argument("--beat-model", default=str(PathConfig().beat_detector_model),
                        help="beat model export (params-only), for --grid tracker")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    out = refuse_committed(args.out, "--out")
    device = resolve_device(args.device)
    corpus = Path(args.corpus)
    tokenized = out / "tokenized"
    tokenized.mkdir(parents=True, exist_ok=True)

    with open(corpus / "metadata.json", "r", encoding="utf-8") as f:
        songs = json.load(f)
    if args.limit:
        songs = songs[: args.limit]

    tracker = TrackerGrid(args.separator_model, args.beat_model, device)
    tempo_cache = out / "tempo"
    tempo_cache.mkdir(parents=True, exist_ok=True)
    grid_stats = Counter()

    all_src, all_tgt, names = [], [], []
    for meta in songs:
        name = meta.get("dir_name")
        song_dir = corpus / name
        src_mid = song_dir / f"{args.src_version}.mid"
        tgt_mid = song_dir / f"{args.tgt_version}.mid"
        if not (src_mid.exists() and tgt_mid.exists()):
            continue
        try:
            src_notes = read_midi_notes(src_mid)
            tgt_notes = read_midi_notes(tgt_mid)
        except Exception as exc:
            logger.warn(f"{name}: MIDI parse failed: {exc}")
            continue
        if len(src_notes) < 32 or len(tgt_notes) < 32:
            continue

        tempo = estimate_tempo_grid(tgt_notes)
        rgc_score = grid_fit_score(tgt_notes, tempo) if tempo else np.inf
        chosen = "rgc"
        if args.grid == "tracker":
            tracker_tempo, tracker_score = tracker_tempo_cached(
                tracker, name, tgt_notes, tempo_cache, out / "distill_grid.wav")
            tempo, chosen = arbitrate_grid(
                tracker_tempo, tracker_score, tempo, rgc_score
            )
            logger.info(
                f"{name}: grid={chosen} "
                f"(snap tracker {tracker_score if np.isfinite(tracker_score) else 'inf'} vs "
                f"rgc {rgc_score:.4f})"
            )
        grid_stats[chosen] += 1
        if tempo is None or not tempo:
            continue
        shifts = [0] + [
            s * sign
            for s in range(1, args.transpose + 1)
            for sign in (1, -1)
        ]
        grid_variants = [("", tempo)]
        grid_variants += [(f"_p{k}", _phase_shift_tempo(tempo, k))
                          for k in range(1, args.phase_shifts + 1)]
        if args.double_time:
            grid_variants.append(("_x2", _double_time_tempo(tempo)))
        for vtag, vtempo in grid_variants:
            for shift in shifts:
                src_k = _transpose_notes(src_notes, shift)
                tgt_k = _transpose_notes(tgt_notes, shift)
                if len(src_k) < 32 or len(tgt_k) < 32:
                    continue
                src_events = TinyREMITokenizer(tempo_data=vtempo).encode(
                    src_k, with_grace_note=True
                )
                tgt_events = TinyREMITokenizer(tempo_data=vtempo).encode(
                    tgt_k, with_grace_note=True
                )
                if src_events and tgt_events:
                    all_src.append(src_events)
                    all_tgt.append(tgt_events)
                    tag = ("" if shift == 0 else f"_t{shift:+d}") + vtag
                    names.append(name + tag)
    logger.info(
        f"tokenized {len(names)} song pairs "
        f"(grids: {dict(grid_stats)})"
    )
    if not names:
        return 1

    # Always rebuild the vocabulary from the full event set: reusing a
    # vocab built from a smaller corpus would map unseen tokens to <UNK>
    # in the saved sequences.
    vocab_path = out / "vocab.json"
    vocab = Vocab()
    vocab.build_from_events(all_src + all_tgt)
    if vocab_path.exists():
        logger.warn(f"overwriting existing vocabulary at {vocab_path}")
    vocab.save(vocab_path)
    logger.info(f"vocab: {len(vocab)} tokens")

    for i in range(len(names)):
        subdir = tokenized / f"{i + 1:04d}"
        subdir.mkdir(parents=True, exist_ok=True)
        vocab.save_id_sequence(all_src[i], subdir / f"{i + 1:04d}_src.npy")
        vocab.save_id_sequence(all_tgt[i], subdir / f"{i + 1:04d}_tgt.npy")
    logger.success(f"dataset written → {tokenized}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
