"""The whole audio → MIDI pipeline over corpus songs, scored beside the
corpus versions (JAX counterpart: scripts/eval_full_pipeline.py).

    python -m etude_tpu_torch.scripts.eval_full_pipeline [--songs 20] [--seconds 180] \\
        [--engine stream|rebuild] [--out DIR] [--versions human etude_d_d etude_d] \\
        [--corpus DIR] [--config settings.json] [--allow-random-weights] [--device cpu]

Per song: the first `--seconds` of the corpus `human.mid` are rendered to a
44.1 kHz piano WAV (the corpus ships MIDI, not recordings: the render stands
in for the audio), `InferencePipeline.run` turns it into
`<out>/<SONG>/out/ours.mid` (extract, structuralize, decode with the
default attributes), and RGC and IPE of it are reported as "ours" beside
the corpus versions of the same song. One JSON line goes to stdout: the
means and the per-song rows, with each song's wall.

The weights come from the settings file (`--config`, as `infer` reads it);
a missing checkpoint is an error unless `--allow-random-weights`, an orbax
one raises. On a card, stage 2 runs the dilated-attention kernel and the
decode the decode-attention kernel. The JAX script's `/tmp` default output
becomes `etude_torch_fullpipe` in the temporary directory;
`dataset_distill/`, `validation/` and `checkpoints/` are refused.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from . import refuse_committed
from ..data.corpus_render import CORPUS_ROOT
from ..utils.device import resolve_device

DEFAULT_OUT = Path(tempfile.gettempdir()) / "etude_torch_fullpipe"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Full-pipeline corpus evaluation")
    parser.add_argument("--songs", type=int, default=20)
    parser.add_argument("--seconds", type=float, default=180.0)
    parser.add_argument("--engine", default="stream", choices=["stream", "rebuild"])
    parser.add_argument("--out", default=str(DEFAULT_OUT))
    parser.add_argument("--versions", nargs="+", default=["human", "etude_d_d", "etude_d"])
    parser.add_argument("--corpus", default=str(CORPUS_ROOT))
    parser.add_argument("--config", default=None,
                        help="settings file (.json, or YAML with PyYAML)")
    parser.add_argument("--allow-random-weights", action="store_true")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    from ..config import load_config
    from ..data.synthetic import render_piano
    from ..evaluation.metrics import IPECalculator, RGCCalculator
    from ..infer import InferencePipeline
    from ..utils.audio import save_wav
    from ..utils.logger import logger
    from ..utils.midi import read_midi_notes

    out = refuse_committed(args.out, "--out")
    device = resolve_device(args.device)
    corpus = Path(args.corpus)
    songs = sorted(d.name for d in corpus.iterdir()
                   if d.is_dir() and (d / "human.mid").exists())[: args.songs] \
        if corpus.is_dir() else []
    if not songs:
        logger.error(f"no corpus songs under {corpus}")
        return 1

    rgc = RGCCalculator(top_k=8)
    ipe = IPECalculator(n_gram=8, n_clusters=16)
    attrs = {"polyphony_bin": 1, "rhythm_intensity_bin": 1,
             "sustain_bin": 1, "pitch_overlap_bin": 2}

    rows = []
    for i, song in enumerate(songs):
        work = out / song
        if work.exists():
            shutil.rmtree(work)
        work.mkdir(parents=True)
        notes = [n for n in read_midi_notes(corpus / song / "human.mid")
                 if n["onset"] < args.seconds - 2]
        wave = render_piano(notes, args.seconds, sr=44100)
        save_wav(work / "song.wav", wave, 44100)

        cfg = load_config(args.config, overrides={
            "paths": {"infer_output_dir": str(work / "out")},
        })
        pipeline = InferencePipeline(cfg, device=device, engine_kind=args.engine,
                                     allow_random_weights=args.allow_random_weights)
        t0 = time.perf_counter()
        pipeline.run(str(work / "song.wav"), attrs, final_filename="ours")
        wall = time.perf_counter() - t0

        ours = work / "out" / "ours.mid"
        row = {"song": song, "wall_s": round(wall, 2)}
        row["rgc_ours"] = rgc.calculate(ours).get("rgc_score")
        row["ipe_ours"] = ipe.calculate(ours).get("ipe_score")
        row["n_notes"] = len(read_midi_notes(ours))
        for v in args.versions:
            mid = corpus / song / f"{v}.mid"
            if mid.exists():
                row[f"rgc_{v}"] = rgc.calculate(mid).get("rgc_score")
                row[f"ipe_{v}"] = ipe.calculate(mid).get("ipe_score")
        rows.append(row)

        def fmt(v, spec):  # a metric's .get() is None on a degenerate MIDI
            return format(v, spec) if v is not None else "n/a"

        logger.info(
            f"[{i + 1}/{len(songs)}] {song}: {wall:.1f}s, "
            f"{row['n_notes']} notes, rgc {fmt(row['rgc_ours'], '.4f')} "
            f"ipe {fmt(row['ipe_ours'], '.2f')}"
        )

    def mean(key):
        vals = [r[key] for r in rows if r.get(key) is not None]
        return round(float(np.mean(vals)), 4) if vals else None

    summary = {
        "songs": len(rows),
        "song_seconds": args.seconds,
        "engine": args.engine,
        "mean_wall_s": mean("wall_s"),
        "rgc": {"ours": mean("rgc_ours"), **{v: mean(f"rgc_{v}") for v in args.versions}},
        "ipe": {"ours": mean("ipe_ours"), **{v: mean(f"ipe_{v}") for v in args.versions}},
        "rows": rows,
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
