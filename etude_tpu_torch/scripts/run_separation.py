"""Standalone source separation (JAX counterpart: scripts/run_separation.py):
audio in, the (5, time, 128) dB-mel separation features out as an f32 `.npy`
(the file `BeatDetector.detect` reads).

    python -m etude_tpu_torch.scripts.run_separation --input song.wav \\
        --output features.npy [--model DIR] [--device cpu]

`--model` is a separator export in the port's params-only format (a
directory holding params.npz, as `python -m etude_tpu_torch.train_aux
separator` writes); without it the separator runs with random weights from
seed 0, as the JAX script's does. A `--model` that does not exist, or that
the port cannot read (the committed orbax checkpoint), raises.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from . import refuse_checkpoints
from ..data.separation import SourceSeparator
from ..utils.logger import logger


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="5-stem separation → mel feature extraction")
    parser.add_argument("--input", required=True, help="input audio file")
    parser.add_argument("--output", required=True, help="output .npy path")
    parser.add_argument("--model", default=None, help="separator checkpoint")
    parser.add_argument("--backend", default="torch_unet", choices=["torch_unet"],
                        help="separation backend (the port's U-Net, models/separator.py)")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    output = refuse_checkpoints(args.output, "--output")

    if not Path(args.input).exists():
        logger.error(f"input audio not found: {args.input}")
        return 1

    separator = SourceSeparator(model_path=args.model, device=args.device,
                                allow_random_weights=args.model is None)
    features = separator.separate_features(args.input, output)
    logger.success(f"features {features.shape} → {output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
