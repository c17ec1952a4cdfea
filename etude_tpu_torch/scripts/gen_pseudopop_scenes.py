"""Pseudo-pop beat-training scenes (JAX counterpart:
scripts/gen_pseudopop_scenes.py).

  corpus MIDI (snap-gated grids, train split only; the eval split of
  eval_separator_pseudopop is never touched)
    → random 512-frame window, expressive piano augmentation (onset jitter,
      transposition, velocity scale, note dropout; labels stay on the grid)
    → five pseudo-pop stems (data/pseudopop.py: formant vocals, the piano,
      chord pad, bass root line, grid-locked drums with timing
      humanization) with per-stem gain augmentation and stem dropout
      (percussion-less scenes included)
    → 44.1 kHz mix, int16-quantized (the serving signal chain)
    → the separator's feature transform ([5, T, 128] dB-mel)
    → beat/downbeat activation labels from the known grid.

Two stages, so that the host's rendering and the device's features can run
apart:

    python -m etude_tpu_torch.scripts.gen_pseudopop_scenes --stage render \\
        [--n-scenes 1600] [--out outputs/pseudopop_scenes] [--corpus DIR]
    python -m etude_tpu_torch.scripts.gen_pseudopop_scenes --stage features \\
        [--out ...] [--separator-model DIR] [--device cpu]

`render` (host only) writes `<out>/raw/scene_NNNNN.npz` (`mix_i16`,
`activations`, `tempo`); `features` runs the separator on `--device` and
writes `<out>/shard_NNNN.npz` in the gen_beat_scenes format, which `train_aux
beat --scenes-dir` reads.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from ..config import PathConfig
from . import REPO, refuse_checkpoints
from .gen_beat_scenes import T_FRAMES, scene_features, snap_gated_pool, window_labels
from ..data.corpus_render import CORPUS_ROOT
from ..data.pseudopop import MIX_GAINS, STEM_NAMES, build_stems
from ..data.synthetic import BEAT_FPS
from ..utils.logger import logger

# Stem dropout probabilities: robustness to thin arrangements, including
# percussion-less passages (pseudo-pop scenes drop drums 20% of the time).
DROP_P = {"vocals": 0.25, "piano": 0.10, "guitar": 0.25, "bass": 0.20,
          "drums": 0.20}


def sample_window(rng: np.random.Generator, pool, dur: float):
    """One augmented pseudo-pop window spec: (aug_notes, b_in, d_in, gains,
    drum_jitter, act, bpm) or None when the sampled window is unusable.
    Shared by the beat scenes below and the separator's pseudo-pop rows
    (`train_aux separator --pseudopop-mix`)."""
    song, version, notes, tempo = pool[rng.integers(len(pool))]
    last = max(n["offset"] for n in notes)
    if last < dur + 2.0:
        return None
    t0 = float(rng.uniform(0.0, last - dur - 1.0))

    act, b_in, d_in, bpm = window_labels(tempo, t0, dur, BEAT_FPS)
    if len(b_in) < 10 or not (40.0 <= bpm <= 260.0):
        return None

    win = [n for n in notes
           if n["onset"] < t0 + dur and n["offset"] > t0 and n["onset"] >= t0 - 2.0]
    if len(win) < 16:
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
            "onset": max(onset, 0.0),
            "offset": max(onset, 0.0) + length,
            "pitch": int(np.clip(n["pitch"] + transpose, 21, 108)),
            "velocity": int(np.clip(round(n["velocity"] * vel_scale), 1, 127)),
        })
    aug = [n for n in aug if n["offset"] > 0.0 and n["onset"] < dur]
    if len(aug) < 12:
        return None

    gains = {}
    for name in STEM_NAMES:
        if rng.random() < DROP_P[name]:
            gains[name] = 0.0
        else:
            gains[name] = MIX_GAINS[name] * float(rng.uniform(0.6, 1.4))
    if sum(1 for g in gains.values() if g > 0) < 2:
        gains["piano"] = MIX_GAINS["piano"]
        gains["drums"] = MIX_GAINS["drums"]
    return aug, b_in, d_in, gains, float(rng.uniform(0.0, 0.012)), act, bpm


def make_scene_raw(rng: np.random.Generator, pool):
    """One augmented pseudo-pop window → (mix int16 [n], act [T,2] f16,
    tempo i32) or None when the sampled window is unusable."""
    dur = T_FRAMES / BEAT_FPS
    spec = sample_window(rng, pool, dur)
    if spec is None:
        return None
    aug, b_in, d_in, gains, drum_jitter, act, bpm = spec

    mix, _stems, _beats = build_stems(
        aug, b_in, d_in, dur + 0.3, sr=44100,
        seed=int(rng.integers(2 ** 31)),
        gains=gains, drum_jitter=drum_jitter, rng=rng,
    )
    if float(np.abs(mix).max()) < 1e-4:
        return None
    # The mix is already int16-quantized by build_stems; store it losslessly.
    mix_i16 = np.round(mix * 32767.0).astype(np.int16)
    return mix_i16, act.astype(np.float16), np.int32(np.clip(round(bpm), 0, 299))


def stage_render(args) -> int:
    from ..data.corpus_render import corpus_song_dirs, split_songs

    train_dirs, eval_dirs = split_songs(corpus_song_dirs(Path(args.corpus)))
    logger.info(f"train split: {len(train_dirs)} songs "
                f"(eval split {len(eval_dirs)} excluded)")
    pool = snap_gated_pool(train_dirs, args.snap_gate)
    logger.info(f"snap-gated pool: {len(pool)} (song, version) grids")
    if not pool:
        logger.error("no snap-gated songs; nothing to generate")
        return 1

    raw = args.out / "raw"
    raw.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    existing = len(list(raw.glob("scene_*.npz")))
    n_done, attempts = existing, 0
    while n_done < args.n_scenes and attempts < args.n_scenes * 12:
        attempts += 1
        scene = make_scene_raw(rng, pool)
        if scene is None:
            continue
        mix_i16, act, tempo = scene
        np.savez_compressed(
            raw / f"scene_{n_done:05d}.npz",
            mix_i16=mix_i16, activations=act, tempo=tempo,
        )
        n_done += 1
        if n_done % 100 == 0:
            logger.info(f"rendered {n_done}/{args.n_scenes}")
    logger.success(f"rendered {n_done} raw scenes to {raw}")
    return 0


def stage_features(args) -> int:
    from ..data.separation import SourceSeparator

    raw = args.out / "raw"
    files = sorted(raw.glob("scene_*.npz"))
    if not files:
        logger.error(f"no raw scenes under {raw}; run --stage render first")
        return 1
    separator = SourceSeparator(model_path=args.separator_model, device=args.device,
                                allow_random_weights=True)
    out = args.out
    xs, acts, tempos, shard_idx = [], [], [], 0
    for i, f in enumerate(files):
        with np.load(f) as z:
            mix = z["mix_i16"].astype(np.float32) / 32767.0
            act, tempo = z["activations"], z["tempo"]
        xs.append(scene_features(separator, mix).astype(np.float16))
        acts.append(act.astype(np.float16))
        tempos.append(np.int32(tempo))
        if len(xs) == args.shard_size or i == len(files) - 1:
            np.savez_compressed(
                out / f"shard_{shard_idx:04d}.npz",
                x=np.stack(xs), activations=np.stack(acts),
                tempo=np.asarray(tempos, np.int32),
            )
            shard_idx += 1
            xs, acts, tempos = [], [], []
            if shard_idx % 5 == 0:
                logger.info(f"features {i + 1}/{len(files)} "
                            f"({shard_idx} shards)")
    meta = {"n_scenes": len(files), "shards": shard_idx,
            "t_frames": T_FRAMES, "seed": args.seed, "domain": "pseudo-pop",
            "drop_p": DROP_P}
    with open(out / "meta.json", "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=2)
    logger.success(f"wrote {shard_idx} shards ({len(files)} scenes) to {out}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Pseudo-pop beat-training scenes")
    parser.add_argument("--stage", choices=["render", "features"],
                        required=True)
    parser.add_argument("--n-scenes", type=int, default=1600)
    parser.add_argument("--shard-size", type=int, default=64)
    parser.add_argument("--out",
                        default=str(REPO / "outputs" / "pseudopop_scenes"))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--snap-gate", type=float, default=0.02)
    parser.add_argument("--corpus", default=str(CORPUS_ROOT))
    parser.add_argument("--separator-model", default=str(PathConfig().separator_model),
                        help="features stage: separator export (params-only)")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="features stage: where the separator runs")
    args = parser.parse_args(argv)
    args.out = refuse_checkpoints(args.out, "--out")
    return (stage_render if args.stage == "render" else stage_features)(args)


if __name__ == "__main__":
    sys.exit(main())
