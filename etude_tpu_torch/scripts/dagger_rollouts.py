"""The decoder's own free-running covers over a tokenized corpus, saved as
per-song `NNNN_hist.npy` rollout files (JAX counterpart:
scripts/dagger_rollouts.py, whose docstring gives the why: DAgger against
exposure bias).

    python -m etude_tpu_torch.scripts.dagger_rollouts --run outputs/train_distill/<id> \\
        [--dataset-dir dataset_distill] [--batch 16] [--limit N] [--device cpu]

Each song is generated by the streaming engine, `--batch` songs in lockstep
(greedy unless `--temperature`), conditioned on the per-bar oracle
attribute bins under the dataset-global edges (computed over every song
before `--stride`/`--stride-offset`/`--limit` select some). The file holds
every bar's tokens, each bar opening with Bar_BOS, as one flat int32 array;
`python -m etude_tpu_torch.train` reads it as the history bars when
`train.dagger_history` is set. Existing files are kept unless `--force`
(and then, with `--skip-newer-than F`, those newer than F are kept too).
The repository's `dataset_distill/` holds the JAX package's committed
rollouts: `--force` into it is refused.

Every S = 1 step of the engine runs the decode-attention kernel on every
layer on a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from . import REPO, refuse_checkpoints
from ..data.dataset import (
    bin_attribute, calculate_bin_edges, compute_relative_attributes, extract_bar_features,
    split_ids_into_bars,
)
from ..data.vocab import Vocab
from ..models.attr_prior import NAME_TO_KEY
from ..models.generate_stream import StreamingGenerationEngine
from ..utils.device import resolve_device
from ..utils.logger import logger
from ..utils.model_loader import load_etude_decoder


@dataclasses.dataclass
class RolloutRun:
    """What a run did: the files it wrote (in generation order), the bars
    and tokens in them (Bar_BOS included), the seconds of generation, and
    the engine's S = 1 chunks."""

    written: List[Path]
    bars: int
    tokens: int
    seconds: float
    single_token_chunks: int


def load_songs(tokenized: Path, vocab: Vocab) -> List[Dict]:
    """Per song with `_src` and `_tgt`: its dir, source bars (as many as
    there are bar pairs) and per-bar relative attributes."""
    songs = []
    for subdir in sorted(tokenized.iterdir() if tokenized.exists() else []):
        if not (subdir.is_dir() and subdir.name.isdigit()):
            continue
        src_f = subdir / f"{subdir.name}_src.npy"
        tgt_f = subdir / f"{subdir.name}_tgt.npy"
        if not (src_f.exists() and tgt_f.exists()):
            continue
        src_bars = split_ids_into_bars(np.load(src_f).astype(int).tolist(),
                                       vocab.bar_bos_id, vocab.bar_eos_id)
        tgt_bars = split_ids_into_bars(np.load(tgt_f).astype(int).tolist(),
                                       vocab.bar_bos_id, vocab.bar_eos_id)
        attrs = [compute_relative_attributes(extract_bar_features(sb, vocab),
                                             extract_bar_features(tb, vocab))
                 for sb, tb in zip(src_bars, tgt_bars)]
        songs.append({"dir": subdir, "src_bars": src_bars[:len(attrs)], "attrs": attrs})
    return songs


def bin_maps(attr_list, edges) -> List[Dict[str, int]]:
    """The engine's per-bar attribute dicts under `edges`."""
    return [{key: bin_attribute(a[name], edges.get(name)) for name, key in NAME_TO_KEY.items()}
            for a in attr_list]


def run(argv=None) -> Optional[RolloutRun]:
    """The CLI's work; None where the JAX script exits 1."""
    parser = argparse.ArgumentParser(description="Decoder rollouts for DAgger")
    parser.add_argument("--run", required=True, help="training run dir")
    parser.add_argument("--dataset-dir", default="dataset_distill")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--limit", type=int, default=0)
    parser.add_argument("--stride", type=int, default=1,
                        help="take every k-th song (variants of one base song are "
                             "adjacent, so a stride covers every base song at 1/k "
                             "the cost)")
    parser.add_argument("--stride-offset", type=int, default=0,
                        help="with --stride k: start at this index, so successive "
                             "passes refresh complementary song subsets")
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--force", action="store_true",
                        help="regenerate existing _hist.npy files")
    parser.add_argument("--skip-newer-than", type=str, default=None,
                        help="with --force: keep _hist.npy files newer than this "
                             "file's mtime (resume an interrupted pass)")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    dataset_dir = refuse_checkpoints(args.dataset_dir, "--dataset-dir")
    if args.force and dataset_dir.is_relative_to((REPO / "dataset_distill").resolve()):
        raise ValueError(f"--force into {dataset_dir} would overwrite the JAX package's "
                         "committed rollouts; copy the corpus elsewhere first")
    device = resolve_device(args.device)
    run_dir = Path(args.run)
    vocab = Vocab.load(dataset_dir / "vocab.json")
    model, config = load_etude_decoder(run_dir / "etude_decoder_config.json",
                                       run_dir / "model", device)

    tokenized = dataset_dir / "tokenized"
    songs = load_songs(tokenized, vocab)
    if not songs:
        logger.error(f"no tokenized songs under {tokenized}")
        return None
    # The dataset-GLOBAL edges training uses, over all songs BEFORE the
    # selection, so limited runs condition on the same edges as full runs.
    edges = calculate_bin_edges([a for s in songs for a in s["attrs"]])
    if args.stride > 1:
        songs = songs[args.stride_offset % args.stride::args.stride]
    if args.limit:
        songs = songs[:args.limit]

    engine = StreamingGenerationEngine(config, bar_bos_id=vocab.bar_bos_id,
                                       bar_eos_id=vocab.bar_eos_id, pad_id=vocab.pad_id)
    fresh_after = (Path(args.skip_newer_than).stat().st_mtime
                   if args.skip_newer_than else None)

    def needs(s) -> bool:
        hist = s["dir"] / f"{s['dir'].name}_hist.npy"
        if not hist.exists():
            return True
        if not args.force:
            return False
        return fresh_after is None or hist.stat().st_mtime <= fresh_after

    todo = [s for s in songs if needs(s)]
    # Lockstep batches run to the longest song in the batch; sort by bar
    # count so batches are homogeneous.
    todo.sort(key=lambda s: len(s["src_bars"]), reverse=True)
    logger.info(f"{len(todo)}/{len(songs)} songs need rollouts")

    written, bars, tokens = [], 0, 0
    t = time.perf_counter()
    for i in range(0, len(todo), args.batch):
        chunk = todo[i:i + args.batch]
        streams = engine.generate_batch(
            model, [s["src_bars"] for s in chunk], [bin_maps(s["attrs"], edges) for s in chunk],
            temperature=args.temperature, seed=args.seed + i)
        for s, song_bars in zip(chunk, streams):
            flat = [tok for bar in song_bars for tok in bar]
            out = s["dir"] / f"{s['dir'].name}_hist.npy"
            np.save(out, np.asarray(flat, np.int32))
            written.append(out)
            bars += len(song_bars)
            tokens += len(flat)
        logger.info(f"rollouts {len(written)}/{len(todo)}")
    seconds = time.perf_counter() - t
    logger.success(f"wrote {len(written)} rollout files under {dataset_dir}")
    return RolloutRun(written=written, bars=bars, tokens=tokens, seconds=seconds,
                      single_token_chunks=engine.stats["single_token_chunks"])


def main(argv=None) -> int:
    return 0 if run(argv) is not None else 1


if __name__ == "__main__":
    sys.exit(main())
