"""Warm-start surgery: re-index a trained decoder onto a rebuilt vocabulary
(JAX counterpart: scripts/remap_decoder_warmstart.py). Each corpus build
writes its own vocab.json, so IDs shift and new tokens appear
(dataset_distill's 116 tokens → dataset_distill_r4's 119, which adds
Note_103-Note_105; each borrows Note_102's weights).

    python -m etude_tpu_torch.scripts.remap_decoder_warmstart \\
        --run outputs/train_distill/<id> --old-vocab dataset_distill/vocab.json \\
        --new-vocab dataset_distill_r4/vocab.json \\
        --out outputs/train_distill/<id>_remap_r4 [--device cpu]

Writes `<out>/model` (params-only, f32) and `<out>/etude_decoder_config.json`
with the new vocab size: what `train.init_from` reads. The result is loaded
into the decoder on `--device` before the script returns, as a check that it
serves.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

from . import refuse_checkpoints
from ..data.vocab import Vocab
from ..models.decoder import EtudeDecoderConfig
from ..utils.device import resolve_device
from ..utils.logger import logger
from ..utils.model_loader import remap_decoder_vocab
from ..utils.training import load_params_only, save_params_only
from ..weights import decoder_from_jax


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Re-index a decoder onto a new vocabulary")
    parser.add_argument("--run", required=True)
    parser.add_argument("--old-vocab", required=True)
    parser.add_argument("--new-vocab", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    out = refuse_checkpoints(args.out, "--out")
    device = resolve_device(args.device)

    run = Path(args.run)
    old_vocab = Vocab.load(args.old_vocab)
    new_vocab = Vocab.load(args.new_vocab)
    config = EtudeDecoderConfig.from_json_file(run / "etude_decoder_config.json")
    if config.vocab_size != len(old_vocab):
        logger.warn(f"checkpoint vocab_size {config.vocab_size} != old vocab {len(old_vocab)}")
    params = remap_decoder_vocab(load_params_only(run / "model"), old_vocab, new_vocab)
    config = dataclasses.replace(config, vocab_size=len(new_vocab))
    save_params_only(out / "model", params, config)
    decoder_from_jax(load_params_only(out / "model"), config, device)
    logger.success(f"remapped {len(old_vocab)}→{len(new_vocab)} tokens → {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
