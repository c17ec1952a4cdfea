"""Publish a decoder training run as a serving checkpoint (JAX counterpart:
scripts/publish_decoder.py).

    python -m etude_tpu_torch.scripts.publish_decoder --run outputs/train_distill/<id> \\
        [--out outputs/published/decoder] [--meta '{"corpus": "..."}'] [--device cpu]

Copies the run's params-only export (`python -m etude_tpu_torch.train`
writes `<run>/model`) to `<out>/latest.ckpt` with floats stored as f16
(the loader promotes them back to f32), `<out>/metadata.json` (the source
run, and from the last line of `metrics.jsonl` the epochs, final loss and
tokens per second, with `--meta` merged in), and the run's config and
vocabulary beside it: the layout of the `paths.decoder_model`/`_config`/
`_vocab` defaults. The JAX script's default `--out` is
`checkpoints/decoder`, which holds the JAX package's checkpoint; the port
refuses any path under `checkpoints/`. Point `paths.decoder_model` at
`<out>/latest.ckpt` to serve it. The published weights are loaded into the
decoder on `--device` before the script returns.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

from . import REPO, refuse_checkpoints
from ..utils.device import resolve_device
from ..utils.logger import logger
from ..utils.model_loader import load_etude_decoder
from ..utils.training import load_params_only, save_aux_params

DEFAULT_OUT = REPO / "outputs" / "published" / "decoder"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Publish a decoder training run")
    parser.add_argument("--run", required=True, help="training run dir")
    parser.add_argument("--out", default=str(DEFAULT_OUT))
    parser.add_argument("--meta", default=None,
                        help="extra metadata JSON merged into metadata.json")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    out = refuse_checkpoints(args.out, "--out")

    run = Path(args.run)
    for name in ("model", "etude_decoder_config.json", "vocab.json"):
        if not (run / name).exists():
            print(f"missing {run / name} — did training complete?", file=sys.stderr)
            return 1

    device = resolve_device(args.device)
    params = load_params_only(run / "model")

    metadata = {"source_run": str(run)}
    metrics_path = run / "metrics.jsonl"
    if metrics_path.exists():
        lines = metrics_path.read_text().strip().splitlines()
        if lines:
            last = json.loads(lines[-1])
            metadata.update({
                "epochs": last.get("epoch"),
                "final_loss": last.get("loss"),
                "train_tokens_per_sec": last.get("tokens_per_sec"),
            })
    if args.meta:
        metadata.update(json.loads(args.meta))

    out.mkdir(parents=True, exist_ok=True)
    save_aux_params(out / "latest.ckpt", params, metadata=metadata)
    shutil.copy(run / "etude_decoder_config.json", out / "etude_decoder_config.json")
    shutil.copy(run / "vocab.json", out / "vocab.json")
    load_etude_decoder(out / "etude_decoder_config.json", out / "latest.ckpt", device)
    logger.success(f"published decoder → {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
