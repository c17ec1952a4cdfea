"""The distilled corpus as the benchmark reads it: the condition (source)
token stream of each song, split into bars. A frozen copy of the corpus
layout (`<dir>/<id>/<id>_src.npy`) and of the bar rule of
`etude_tpu_torch/data/tokenizer.py` `split_sequence_into_bars`, so that a
change to the program cannot change the benchmark's inputs."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np


def vocab_ids(vocab_path: Path) -> Dict[str, int]:
    """The special ids the decoder's traffic needs."""
    with open(vocab_path, encoding="utf-8") as f:
        token_to_id = json.load(f)["token_to_id"]
    return {"bar_bos": token_to_id["Bar_BOS"], "bar_eos": token_to_id["Bar_EOS"],
            "pad": token_to_id["<PAD>"], "vocab_size": len(token_to_id)}


def split_bars(ids: List[int], bos: int, eos: int) -> List[List[int]]:
    """Complete [Bar_BOS ... Bar_EOS] bars of a token stream (an open bar at
    the end is kept; tokens outside a bar are dropped)."""
    bars: List[List[int]] = []
    current: List[int] = []
    in_bar = False
    for tok in ids:
        if tok == bos:
            if in_bar and current:
                bars.append(current)
            current, in_bar = [tok], True
        elif tok == eos:
            if in_bar:
                current.append(tok)
                bars.append(current)
                current, in_bar = [], False
        elif in_bar:
            current.append(tok)
    if in_bar and current:
        bars.append(current)
    return bars


def song_ids(tokenized_dir: Path) -> List[str]:
    return sorted(p.name for p in Path(tokenized_dir).iterdir()
                  if (p / f"{p.name}_src.npy").exists())


def load_corpus(tokenized_dir: Path, bos: int, eos: int) -> Dict[str, List[List[int]]]:
    """{song id: its condition bars}."""
    tokenized_dir = Path(tokenized_dir)
    return {sid: split_bars(np.load(tokenized_dir / sid / f"{sid}_src.npy").tolist(),
                            bos, eos)
            for sid in song_ids(tokenized_dir)}
