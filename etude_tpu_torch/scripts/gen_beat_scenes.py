"""Piano-domain beat-training scenes from rendered corpus MIDI (JAX
counterpart: scripts/gen_beat_scenes.py).

Scenes whose grids are exact by construction, in the serving domain:

  corpus MIDI (snap-gated to a constant grid, train split only)
    → random 512-frame window, expressive augmentation (onset jitter,
      transposition, velocity scale, note dropout)
    → 44.1 kHz additive-synth render + int16 quantization (the serving
      signal chain, data/corpus_render.py)
    → the separator's feature transform ([5, T, 128] dB-mel, what the
      beat model sees at serving)
    → beat/downbeat activation labels from the known grid (madmom ±1
      widening), tempo class.

Onset jitter moves the notes while the labels stay on the grid.

    python -m etude_tpu_torch.scripts.gen_beat_scenes [--n-scenes 2000] \\
        [--out outputs/beat_scenes] [--corpus DIR] [--separator-model DIR] \\
        [--device cpu]

Writes `<out>/shard_NNNN.npz` (`x` [n, 5, 512, 128] f16, `activations`
[n, 512, 2] f16, `tempo` [n] i32), which `train_aux beat --scenes-dir`
mixes into its batches, and `<out>/meta.json`.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from ..config import PathConfig
from . import REPO, refuse_checkpoints
from .distill_dataset import estimate_tempo_grid, grid_fit_score
from .validate_beat_corpus import grid_beat_times
from ..data.corpus_render import CORPUS_ROOT, corpus_song_dirs, split_songs
from ..data.synthetic import BEAT_FPS, render_piano
from ..utils.logger import logger
from ..utils.midi import read_midi_notes

T_FRAMES = 512
VERSIONS = ("etude_d", "etude_d_d", "music2midi")


def snap_gated_pool(train_dirs, snap_gate: float):
    """[(song, version, notes, tempo)] for every train-split MIDI whose
    onsets snap to its inferred constant grid within snap_gate seconds."""
    pool = []
    for d in train_dirs:
        for v in VERSIONS:
            mid = d / f"{v}.mid"
            if not mid.exists():
                continue
            notes = read_midi_notes(mid)
            if len(notes) < 128:
                continue
            tempo = estimate_tempo_grid(notes)
            if not tempo:
                continue
            snap = grid_fit_score(notes, tempo)
            if np.isfinite(snap) and snap <= snap_gate:
                pool.append((d.name, v, notes, tempo))
    return pool


def window_labels(tempo, t0: float, dur: float, fps: float):
    """(activations [T,2], beat_times, down_times, bpm) for window [t0,t0+dur)."""
    horizon = t0 + dur + 1.0
    beats = grid_beat_times(tempo, horizon)
    downs = np.asarray(
        [t for r in tempo for t in r["downbeats"] if t < horizon], float
    )
    b_in = beats[(beats >= t0) & (beats < t0 + dur)] - t0
    d_in = downs[(downs >= t0) & (downs < t0 + dur)] - t0
    act = np.zeros((T_FRAMES, 2), np.float32)
    for times, col in ((b_in, 0), (d_in, 1)):
        for t in times:
            frame = int(round(t * fps))
            for dd, w in ((-1, 0.5), (0, 1.0), (1, 0.5)):
                f = frame + dd
                if 0 <= f < T_FRAMES:
                    act[f, col] = max(act[f, col], w)
    bpm = 60.0 / float(np.median(np.diff(b_in))) if len(b_in) > 3 else 0.0
    return act, b_in, d_in, bpm


def scene_features(separator, wave: np.ndarray) -> np.ndarray:
    """A 44.1 kHz scene wave → its separation features cut or padded (with
    the -80 dB floor) to T_FRAMES frames, [5, T_FRAMES, 128] f32."""
    feats = separator.separate_features(None, wave_sr=(wave, 44100))
    feats = np.asarray(feats, np.float32)[:, :T_FRAMES]
    if feats.shape[1] < T_FRAMES:
        feats = np.pad(feats, ((0, 0), (0, T_FRAMES - feats.shape[1]), (0, 0)),
                       constant_values=-80.0)
    return feats


def make_scene(rng, pool, separator):
    """One augmented window → (features [5,T,128] f16, act [T,2] f16, tempo)
    or None when the sampled window is unusable."""
    song, version, notes, tempo = pool[rng.integers(len(pool))]
    dur = T_FRAMES / BEAT_FPS
    last = max(n["offset"] for n in notes)
    if last < dur + 2.0:
        return None
    t0 = float(rng.uniform(0.0, last - dur - 1.0))

    act, b_in, _d, bpm = window_labels(tempo, t0, dur, BEAT_FPS)
    if len(b_in) < 10 or not (40.0 <= bpm <= 260.0):
        return None

    win = [n for n in notes
           if n["onset"] < t0 + dur and n["offset"] > t0 and n["onset"] >= t0 - 2.0]
    if len(win) < 24:
        return None

    transpose = int(rng.integers(-5, 7))
    vel_scale = float(rng.uniform(0.75, 1.25))
    sigma = float(rng.uniform(0.0, 0.030))   # expressive onset jitter (s)
    dropout = float(rng.uniform(0.0, 0.15))
    aug = []
    for n in win:
        if rng.random() < dropout:
            continue
        jit = float(np.clip(rng.normal(0.0, sigma), -2 * sigma, 2 * sigma))
        onset = n["onset"] - t0 + jit
        length = n["offset"] - n["onset"]
        aug.append({
            "onset": onset,
            "offset": onset + length,
            "pitch": int(np.clip(n["pitch"] + transpose, 21, 108)),
            "velocity": int(np.clip(round(n["velocity"] * vel_scale), 1, 127)),
        })
    aug = [n for n in aug if n["offset"] > 0.0 and n["onset"] < dur]
    if len(aug) < 20:
        return None
    for n in aug:
        n["onset"] = max(n["onset"], 0.0)

    wave = render_piano(aug, dur + 0.5, sr=44100)
    wave = (np.clip(wave, -1, 1) * 32767).astype(np.int16).astype(
        np.float32) / 32767.0  # serving int16 WAV quantization

    feats = scene_features(separator, wave)
    return (feats.astype(np.float16), act.astype(np.float16),
            np.int32(np.clip(round(bpm), 0, 299)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Corpus-piano beat-training scenes")
    parser.add_argument("--n-scenes", type=int, default=2000)
    parser.add_argument("--shard-size", type=int, default=64)
    parser.add_argument("--out", default=str(REPO / "outputs" / "beat_scenes"))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--snap-gate", type=float, default=0.02)
    parser.add_argument("--corpus", default=str(CORPUS_ROOT))
    parser.add_argument("--separator-model", default=str(PathConfig().separator_model),
                        help="separator export (params-only)")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    out = refuse_checkpoints(args.out, "--out")

    from ..data.separation import SourceSeparator

    train_dirs, eval_dirs = split_songs(corpus_song_dirs(Path(args.corpus)))
    logger.info(f"train split: {len(train_dirs)} songs "
                f"(eval split {len(eval_dirs)} excluded)")
    pool = snap_gated_pool(train_dirs, args.snap_gate)
    logger.info(f"snap-gated pool: {len(pool)} (song, version) grids")
    if not pool:
        logger.error("no snap-gated songs; nothing to generate")
        return 1

    separator = SourceSeparator(model_path=args.separator_model, device=args.device,
                                allow_random_weights=True)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed)

    xs, acts, tempos = [], [], []
    n_done, shard_idx, attempts = 0, 0, 0
    while n_done < args.n_scenes and attempts < args.n_scenes * 12:
        attempts += 1
        scene = make_scene(rng, pool, separator)
        if scene is None:
            continue
        xs.append(scene[0])
        acts.append(scene[1])
        tempos.append(scene[2])
        n_done += 1
        if len(xs) == args.shard_size or n_done == args.n_scenes:
            np.savez_compressed(
                out / f"shard_{shard_idx:04d}.npz",
                x=np.stack(xs), activations=np.stack(acts),
                tempo=np.asarray(tempos, np.int32),
            )
            shard_idx += 1
            xs, acts, tempos = [], [], []
            if shard_idx % 5 == 0 or n_done == args.n_scenes:
                logger.info(f"{n_done}/{args.n_scenes} scenes "
                            f"({shard_idx} shards)")
    meta = {"n_scenes": n_done, "shards": shard_idx, "pool": len(pool),
            "snap_gate": args.snap_gate, "versions": list(VERSIONS),
            "t_frames": T_FRAMES, "seed": args.seed}
    with open(out / "meta.json", "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=2)
    logger.success(f"wrote {n_done} scenes to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
