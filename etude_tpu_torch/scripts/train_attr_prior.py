"""Fit the per-bar attribute-prompt predictor on a tokenized corpus (JAX
counterpart: scripts/train_attr_prior.py).

    python -m etude_tpu_torch.scripts.train_attr_prior [--dataset dataset_distill] \\
        [--out outputs/attr_prior/attr_prior] [--steps 3000] [--device cpu]

Per bar pair of every song: the source bar's features (`models/attr_prior.
bar_feature_vector`) and the target's attribute bins under the same
dataset-global edges the decoder's training uses (`EtudeDataset`'s, over
bars split by the dataset's splitter; the pairs themselves are split by the
tokenizer's, as the JAX script does). Songs are split into fit and held-out
sets with numpy's `default_rng(seed)`; the fit (`AttrPrior.fit`, f64) runs
on `--device`. Writes `weights.npz` and `meta.json` (the JAX script's keys)
to `--out` and prints the meta as one JSON line. Serve it with
`--attrs-prior` and `paths.checkpoints_dir` = the parent of `--out` (the
CLI reads `<checkpoints_dir>/attr_prior`). The JAX script's default `--out`
is `checkpoints/attr_prior`; the port refuses any path under
`checkpoints/`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from collections import Counter
from pathlib import Path
from typing import Any, Dict

import numpy as np

from . import REPO, refuse_checkpoints
from ..data.dataset import (
    EtudeDataset, bin_attribute, compute_relative_attributes, extract_bar_features,
)
from ..data.tokenizer import split_sequence_into_bars
from ..data.vocab import Vocab
from ..models.attr_prior import ATTR_NAMES, AttrPrior, bar_feature_vector
from ..utils.device import resolve_device
from ..utils.logger import logger

DEFAULT_OUT = REPO / "outputs" / "attr_prior" / "attr_prior"


@dataclasses.dataclass
class PriorRun:
    """What a run did: the meta it wrote, the seconds spent on the host
    building the bar pairs (the edges' dataset load included) and in the fit
    on the device."""

    meta: Dict[str, Any]
    feature_seconds: float
    fit_seconds: float


def bar_pairs(tokenized: Path, vocab: Vocab, edges):
    """(X [N, N_FEATURES] f64, y name → [N] int64, song index per row, the
    number of `_src` files) over every song of `tokenized`."""
    X_rows, y_rows = [], {n: [] for n in ATTR_NAMES}
    song_ids = []
    srcs = sorted(tokenized.glob("*/*_src.npy"))
    for si, src_f in enumerate(srcs):
        tgt_f = src_f.with_name(src_f.name.replace("_src", "_tgt"))
        if not tgt_f.exists():
            continue
        src_bars = split_sequence_into_bars(np.load(src_f).astype(int).tolist(),
                                            vocab.bar_bos_id, vocab.bar_eos_id)
        tgt_bars = split_sequence_into_bars(np.load(tgt_f).astype(int).tolist(),
                                            vocab.bar_bos_id, vocab.bar_eos_id)
        n = min(len(src_bars), len(tgt_bars))
        for i in range(n):
            sf = extract_bar_features(src_bars[i], vocab)
            tf = extract_bar_features(tgt_bars[i], vocab)
            raw = compute_relative_attributes(sf, tf)
            X_rows.append(bar_feature_vector(sf, i, n))
            for name in ATTR_NAMES:
                y_rows[name].append(bin_attribute(raw[name], edges.get(name)))
            song_ids.append(si)
    X = np.stack(X_rows).astype(np.float64)
    y = {n: np.asarray(v, np.int64) for n, v in y_rows.items()}
    return X, y, np.asarray(song_ids), len(srcs)


def run(argv=None) -> PriorRun:
    """The CLI's work."""
    parser = argparse.ArgumentParser(description="Fit the attribute-prompt predictor")
    parser.add_argument("--dataset", default=str(REPO / "dataset_distill"))
    parser.add_argument("--out", default=str(DEFAULT_OUT))
    parser.add_argument("--eval-frac", type=float, default=0.1)
    parser.add_argument("--steps", type=int, default=3000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    out = refuse_checkpoints(args.out, "--out")
    device = resolve_device(args.device)

    t = time.perf_counter()
    dataset = Path(args.dataset)
    vocab = Vocab.load(dataset / "vocab.json")
    tokenized = dataset / "tokenized"
    edges = EtudeDataset(tokenized, vocab, max_seq_len=1024).attribute_bin_edges
    X, y, song_ids, n_srcs = bar_pairs(tokenized, vocab, edges)
    feature_seconds = time.perf_counter() - t
    logger.info(f"{len(X)} bar pairs from {n_srcs} songs ({feature_seconds:.2f} s)")

    # Song-level split (bars of one song are correlated).
    rng = np.random.default_rng(args.seed)
    uniq = np.unique(song_ids)
    rng.shuffle(uniq)
    n_eval = max(int(len(uniq) * args.eval_frac), 1)
    is_eval = np.isin(song_ids, uniq[:n_eval].tolist())
    Xtr, Xev = X[~is_eval], X[is_eval]
    ytr = {n: v[~is_eval] for n, v in y.items()}
    yev = {n: v[is_eval] for n, v in y.items()}

    t = time.perf_counter()
    prior = AttrPrior.fit(Xtr, ytr, steps=args.steps, seed=args.seed, device=device)
    fit_seconds = time.perf_counter() - t
    logger.info(f"fit: {args.steps} steps on {device} ({fit_seconds:.2f} s)")
    acc = prior.accuracy(Xev, yev)
    base = {n: float(max(Counter(ytr[n].tolist()).values()) / len(ytr[n]))
            for n in ATTR_NAMES}
    for n in ATTR_NAMES:
        logger.info(f"{n}: held-out acc {acc[n]:.3f} (majority baseline {base[n]:.3f})")

    meta = {
        "bar_pairs": int(len(X)),
        "songs": int(len(uniq)),
        "eval_songs": int(n_eval),
        "heldout_accuracy": {n: round(acc[n], 4) for n in ATTR_NAMES},
        "majority_baseline": {n: round(base[n], 4) for n in ATTR_NAMES},
        "steps": args.steps,
        "dataset": str(dataset),
    }
    prior.save(out, meta=meta)
    logger.success(f"saved attr prior → {out}")
    return PriorRun(meta=meta, feature_seconds=feature_seconds, fit_seconds=fit_seconds)


def main(argv=None) -> int:
    print(json.dumps(run(argv).meta))
    return 0


if __name__ == "__main__":
    sys.exit(main())
