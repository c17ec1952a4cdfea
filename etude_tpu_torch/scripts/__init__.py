"""The JAX package's scripts (scripts/*.py at the repository's root), each
a module of its own with `main(argv) -> int`:

    python -m etude_tpu_torch.scripts.<name> [--device cpu] ...

  dagger_rollouts          the decoder's free-running rollouts over a
                           tokenized corpus (NNNN_hist.npy), for the DAgger
                           fine-tune (`train.dagger_history`)
  train_attr_prior         fit the attribute-prompt predictor (--attrs-prior)
  remap_decoder_warmstart  re-index a trained decoder onto a rebuilt vocabulary
  publish_decoder          a training run's export as an f16 serving checkpoint
  supervise_train          restart a stalled or crashed training run
  run_separation           audio → the (5, T, 128) dB-mel separation features

Each keeps its JAX counterpart's arguments, defaults and outputs, with two
differences: an explicit `--device` (default `cuda`; without a GPU it raises
unless `--device cpu` is given), and nothing is written under the
repository's `checkpoints/`, which holds the JAX package's checkpoints.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

REPO = Path(__file__).resolve().parents[2]


def refuse_checkpoints(path: Union[str, Path], flag: str) -> Path:
    """`path` resolved; raises when it lies under the repository's
    `checkpoints/`."""
    path = Path(path).resolve()
    if path.is_relative_to((REPO / "checkpoints").resolve()):
        raise ValueError(f"{path} is under checkpoints/, which holds the JAX package's "
                         f"checkpoints; pick another {flag}")
    return path
