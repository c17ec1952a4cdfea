"""A small synthetic stand-in for the reference's rendered corpus
(`docs/songs/<SONG>/<version>.mid`, data/corpus_render.py), made from a seed.

Each song is 4/4 at a constant tempo whose eighth note is a whole number of
hundredths of a second between 0.20 and 0.33 s (90.9–150 bpm), so that
`scripts/distill_dataset.estimate_tempo_grid` recovers its grid exactly and
the snap gate keeps it. Every onset sits on an eighth-note slot from the
first downbeat (which is always struck): a chord in MIDI 43–67 under a top
line in MIDI 60–84, notes one to four eighths long. The versions `etude_d`,
`etude_d_d` and `music2midi` are three draws on the song's grid; `human` is
`etude_d` with its onsets moved by up to 10 ms, as a performance
would be. Songs are CPOP01, CPOP02, ...; with six, `split_songs` holds out
CPOP01 and CPOP04.

For the decoder-corpus scripts each song also gets `etude_e`, the condition
side on the same grid (most of `etude_d`'s notes and a few of another draw,
as an extractor's notes share the song with the cover), and a `wp.json`
whose `human` entry is the diagonal warping path at ALIGN_FRAME_RATE frames
per second: `human` and `etude_e` share one timeline, so the diagonal is
the true mapping. The root gets the reference's `metadata.json`, a list of
`{"dir_name": ...}`. These come from a generator of their own per song, so
the four versions above and `songs.json` are the same for a seed with or
without them.

    python -m etude_tpu_torch.tools.synthetic_corpus --out DIR [--songs 6] \\
        [--seconds 20 30] [--seed 0]

The tests and `chip_smoke.py` point `corpus_render.CORPUS_ROOT` at such a
corpus.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from ..utils.midi import write_midi

VERSIONS = ("human", "etude_d", "etude_d_d", "music2midi")
LEAD_SECONDS = 0.5        # the first downbeat
ALIGN_FRAME_RATE = 50     # the aligner's feature rate (frames per second)


def grid_song(rng: np.random.Generator, eighth: float, seconds: float) -> List[Dict]:
    """One draw of notes on the eighth-note grid of period `eighth` over
    `seconds` (the first downbeat at LEAD_SECONDS, always struck)."""
    notes = []
    n_slots = int((seconds - LEAD_SECONDS - 1.0) / eighth)
    for k in range(n_slots):
        if k > 0 and rng.random() > 0.7:
            continue
        onset = LEAD_SECONDS + k * eighth
        root = int(rng.integers(43, 56))
        chord = [root, root + int(rng.choice([3, 4])), root + 7]
        top = int(rng.integers(60, 85))
        for pitch in chord[:int(rng.integers(2, 4))] + [top]:
            length = int(rng.integers(1, 5)) * eighth * 0.9
            notes.append({"onset": round(onset, 6), "offset": round(onset + length, 6),
                          "pitch": pitch, "velocity": int(rng.integers(60, 111))})
    return notes


def condition_side(rng: np.random.Generator, target: List[Dict], eighth: float,
                   seconds: float) -> List[Dict]:
    """An extractor-like condition for `target` on its grid: four in five
    of its notes, and one in five of another draw's."""
    kept = [n for n in target if rng.random() < 0.8]
    extra = [n for n in grid_song(rng, eighth, seconds) if rng.random() < 0.2]
    return sorted(kept + extra, key=lambda n: (n["onset"], n["pitch"]))


def write_corpus(root: Path, n_songs: int = 6, seconds: Sequence[float] = (20.0, 30.0),
                 seed: int = 0) -> List[Path]:
    """Write `n_songs` songs of `seconds[0]`–`seconds[1]` s under `root`;
    returns their directories. A `songs.json` beside them records each
    song's bpm, eighth-note period and length; `metadata.json` lists the
    songs as the reference's does."""
    rng = np.random.default_rng(seed)
    root = Path(root)
    dirs, meta = [], {}
    for i in range(n_songs):
        eighth = int(rng.integers(20, 34)) / 100.0
        length = float(rng.uniform(*seconds))
        song = root / f"CPOP{i + 1:02d}"
        draws = {v: grid_song(rng, eighth, length) for v in VERSIONS[1:]}
        shifts = np.clip(rng.normal(0.0, 0.005, len(draws["etude_d"])), -0.01, 0.01)
        draws["human"] = [dict(n, onset=max(n["onset"] + float(dt), 0.0))
                          for n, dt in zip(draws["etude_d"], shifts)]
        for version in VERSIONS:
            write_midi(draws[version], song / f"{version}.mid")
        meta[song.name] = {"bpm": 30.0 / eighth, "eighth_s": eighth, "seconds": length,
                           "notes": {v: len(draws[v]) for v in VERSIONS}}
        write_midi(condition_side(np.random.default_rng([seed, i, 1]), draws["etude_d"],
                                  eighth, length), song / "etude_e.mid")
        frames = list(range(int(round(length * ALIGN_FRAME_RATE))))
        (song / "wp.json").write_text(json.dumps({"human": {
            "wp": [frames, frames], "pitch_shift": 0,
            "num_frames_cover": len(frames), "num_frames_origin": len(frames)}}))
        dirs.append(song)
    (root / "songs.json").write_text(json.dumps(meta, indent=1))
    (root / "metadata.json").write_text(json.dumps([{"dir_name": d.name} for d in dirs]))
    return dirs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Write a synthetic rendered-corpus stand-in")
    parser.add_argument("--out", required=True)
    parser.add_argument("--songs", type=int, default=6)
    parser.add_argument("--seconds", type=float, nargs=2, default=(20.0, 30.0))
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    dirs = write_corpus(Path(args.out), args.songs, args.seconds, args.seed)
    print(json.dumps({"songs": [d.name for d in dirs], "root": str(Path(args.out))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
