"""Pre-render pseudo-pop separator training rows on the host (JAX
counterpart: scripts/gen_pseudopop_sep_examples.py).

`train_aux separator --pseudopop-mix` renders five-stem audio windows on the
fly, and that rendering holds the training step up; this script renders
them ahead, and `--pseudopop-cache` reads its shards instead. Each row is
the separator's training contract through the serving STFT
(data/pseudopop.py `separation_example_from_stems`):

  mix_mag   [T, F]    int16-quantized mixture magnitude
  stem_mags [5, T, F] clean gain-scaled stem magnitudes

    python -m etude_tpu_torch.scripts.gen_pseudopop_sep_examples [--n 1200] \\
        [--sep-frames 256] [--out outputs/pseudopop_sep_examples]
    python -m etude_tpu_torch.train_aux separator --pseudopop-mix 0.5 \\
        --pseudopop-cache outputs/pseudopop_sep_examples --init-from ...

Writes `<out>/shard_NNNN.npz` (f16) and `<out>/meta.json`; a rerun tops the
shards up to `--n`. The windows come from the train split of the corpus at
`data/corpus_render.CORPUS_ROOT`. Numpy only: no model runs, so the script
takes no `--device`.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from . import REPO, refuse_checkpoints
from .gen_beat_scenes import snap_gated_pool
from .gen_pseudopop_scenes import sample_window
from ..data import corpus_render as cr
from ..data.pseudopop import build_stems, separation_example_from_stems
from ..utils.logger import logger


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Pseudo-pop separator training rows")
    parser.add_argument("--n", type=int, default=1200)
    parser.add_argument("--sep-frames", type=int, default=256)
    parser.add_argument("--shard-size", type=int, default=128)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--snap-gate", type=float, default=0.02)
    parser.add_argument("--out",
                        default=str(REPO / "outputs" / "pseudopop_sep_examples"))
    args = parser.parse_args(argv)

    out = refuse_checkpoints(args.out, "--out")
    out.mkdir(parents=True, exist_ok=True)
    done = sum(
        int(np.load(f, mmap_mode="r")["mix_mag"].shape[0])
        for f in sorted(out.glob("shard_*.npz"))
    ) if list(out.glob("shard_*.npz")) else 0
    if done >= args.n:
        logger.success(f"{done} examples already under {out}")
        return 0

    train_dirs, _ = cr.split_songs(cr.corpus_song_dirs())
    pool = snap_gated_pool(train_dirs, args.snap_gate)
    logger.info(f"pseudo-pop pool: {len(pool)} grids (train split only)")
    if not pool:
        logger.error("no snap-gated songs; nothing to generate")
        return 1

    rng = np.random.default_rng(args.seed + done)
    T = args.sep_frames
    dur = (T * 1024) / 44100.0 + 0.05

    mixes, stems_l = [], []
    shard_idx = len(list(out.glob("shard_*.npz")))
    n_new = 0
    while done + n_new < args.n:
        spec = sample_window(rng, pool, dur)
        if spec is None:
            continue
        aug, b_in, d_in, gains, drum_jitter, _act, _bpm = spec
        mix, stems, _ = build_stems(
            aug, b_in, d_in, dur, sr=44100,
            seed=int(rng.integers(2 ** 31)),
            gains=gains, drum_jitter=drum_jitter, rng=rng,
        )
        if float(np.abs(mix).max()) < 1e-4:
            continue
        ex = separation_example_from_stems(mix, stems, T=T)
        mixes.append(ex["mix_mag"].astype(np.float16))
        stems_l.append(ex["stem_mags"].astype(np.float16))
        n_new += 1
        if len(mixes) >= args.shard_size or done + n_new >= args.n:
            np.savez_compressed(
                out / f"shard_{shard_idx:04d}.npz",
                mix_mag=np.stack(mixes), stem_mags=np.stack(stems_l),
            )
            shard_idx += 1
            mixes, stems_l = [], []
            logger.info(f"examples {done + n_new}/{args.n} "
                        f"({shard_idx} shards)")

    with open(out / "meta.json", "w", encoding="utf-8") as f:
        json.dump({"n": done + n_new, "t_frames": T, "seed": args.seed,
                   "domain": "pseudo-pop serving STFT"}, f, indent=2)
    logger.success(f"wrote {done + n_new} examples to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
