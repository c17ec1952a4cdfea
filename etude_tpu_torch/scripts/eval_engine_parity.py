"""How far the stream and rebuild engines' full-song covers agree (JAX
counterpart: scripts/eval_engine_parity.py).

    python -m etude_tpu_torch.scripts.eval_engine_parity --run outputs/train_distill/<id> \\
        --vocab dataset_distill/vocab.json [--songs 10] [--temperature 0] \\
        [--corpus DIR] [--dataset-dir DIR] [--out DIR] [--reuse] [--device cpu]

The rebuild engine prefills the 4-pair history prompt again every bar (the
reference's exact semantics); the stream engine keeps the history's K/V
from when each bar was generated (models/generate_stream.py). Bar 0 is
token-exact by test; this script measures whether whole songs stay
equivalent: `eval_distilled` once per engine (same songs, same seed, greedy
by default) into `<out>/rebuild` and `<out>/stream`, then per song the
onset F1 of one engine's notes against the other's (pitch-exact, 100 ms),
the note counts, and RGC and IPE of each. `--reuse` scores existing
per-engine outputs without generating. One JSON line goes to stdout.

`--corpus` and `--dataset-dir` are passed to `eval_distilled` (the JAX
script leaves them at its defaults), and so is `--device`. The JAX
script's `/tmp` default output becomes `etude_torch_engine_parity` in the
temporary directory; `dataset_distill/`, `validation/` and `checkpoints/`
are refused.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

from . import eval_distilled, refuse_committed
from ..data.corpus_render import CORPUS_ROOT
from ..evaluation.metrics import IPECalculator, RGCCalculator, onset_f1
from ..utils.device import resolve_device
from ..utils.logger import logger
from ..utils.midi import read_midi_notes

DEFAULT_OUT = Path(tempfile.gettempdir()) / "etude_torch_engine_parity"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Stream vs rebuild engine on whole songs")
    parser.add_argument("--run", required=True)
    parser.add_argument("--vocab", required=True)
    parser.add_argument("--songs", type=int, default=10)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=str(DEFAULT_OUT))
    parser.add_argument("--reuse", action="store_true",
                        help="score existing per-engine output dirs without regenerating")
    parser.add_argument("--corpus", default=str(CORPUS_ROOT))
    parser.add_argument("--dataset-dir", default="dataset_distill")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    out = refuse_committed(args.out, "--out")
    resolve_device(args.device)
    dirs = {}
    for engine in ("rebuild", "stream"):
        dirs[engine] = out / engine
        if args.reuse and any(dirs[engine].glob("*_ours.mid")):
            continue
        rc = eval_distilled.main([
            "--run", args.run, "--vocab", args.vocab,
            "--songs", str(args.songs), "--engine", engine,
            "--temperature", str(args.temperature),
            "--seed", str(args.seed), "--out", str(dirs[engine]),
            "--corpus", args.corpus, "--dataset-dir", args.dataset_dir,
            "--device", args.device,
        ])
        if rc != 0:
            logger.error(f"eval_distilled failed for engine {engine}")
            return rc

    rgc, ipe = RGCCalculator(top_k=8), IPECalculator(n_gram=8, n_clusters=16)
    rows = []
    for rb_mid in sorted(dirs["rebuild"].glob("*_ours.mid")):
        st_mid = dirs["stream"] / rb_mid.name
        if not st_mid.exists():
            continue
        rb_notes = read_midi_notes(rb_mid)
        st_notes = read_midi_notes(st_mid)
        row = {
            "song": rb_mid.name.replace("_ours.mid", ""),
            "notes_rebuild": len(rb_notes),
            "notes_stream": len(st_notes),
            "cross_f1": onset_f1(rb_notes, st_notes, tolerance=0.1)["f1"],
        }
        for name, path in (("rebuild", rb_mid), ("stream", st_mid)):
            row[f"rgc_{name}"] = rgc.calculate(path).get("rgc_score")
            row[f"ipe_{name}"] = ipe.calculate(path).get("ipe_score")
        rows.append(row)

        def fmt(v, spec):  # a metric's .get() is None on a degenerate MIDI
            return format(v, spec) if v is not None else "n/a"

        logger.info(
            f"{row['song']}: cross-F1 {row['cross_f1']:.3f} "
            f"notes {row['notes_rebuild']}/{row['notes_stream']} "
            f"rgc {fmt(row['rgc_rebuild'], '.4f')}/{fmt(row['rgc_stream'], '.4f')} "
            f"ipe {fmt(row['ipe_rebuild'], '.2f')}/{fmt(row['ipe_stream'], '.2f')}"
        )

    if not rows:
        return 1

    def mean_of(key):
        vals = [r[key] for r in rows if r.get(key) is not None]
        return float(np.mean(vals)) if vals else None

    agg = {
        "songs": len(rows),
        "mean_cross_f1": mean_of("cross_f1"),
        "mean_rgc_rebuild": mean_of("rgc_rebuild"),
        "mean_rgc_stream": mean_of("rgc_stream"),
        "mean_ipe_rebuild": mean_of("ipe_rebuild"),
        "mean_ipe_stream": mean_of("ipe_stream"),
        "temperature": args.temperature,
        "seed": args.seed,
        "rows": rows,
    }
    print(json.dumps(agg))
    return 0


if __name__ == "__main__":
    sys.exit(main())
