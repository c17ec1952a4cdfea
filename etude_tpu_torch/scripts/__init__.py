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
  validate_beat_corpus     beat F of the full structuralize chain on rendered
                           corpus songs whose grid is known (snap-gated)
  gen_beat_scenes          solo-piano beat-training scenes from the corpus
                           (`train_aux beat --scenes-dir`)
  gen_pseudopop_scenes     pseudo-pop beat-training scenes, in two stages:
                           `--stage render` (host) then `--stage features`
  gen_pseudopop_sep_examples  pseudo-pop separator rows (`train_aux separator
                           --pseudopop-cache`), host only
  eval_separator_pseudopop the separator's SI-SDR and the beat F it buys on
                           pseudo-pop mixes of the held-out songs
  distill_dataset          for now only the beat-grid helpers the beat
                           scripts share (its CLI comes with the next slice)

Each keeps its JAX counterpart's arguments, defaults and outputs, with these
differences: an explicit `--device` (default `cuda`; without a GPU it raises
unless `--device cpu` is given) wherever a model runs, and nothing is
written under the repository's `checkpoints/`, which holds the JAX
package's checkpoints. Where a JAX script reads the committed orbax
checkpoint of the separator or the beat model, the port's takes the weights
by a flag, `--separator-model` or `--beat-model`: a params-only export,
by default the one `python -m etude_tpu_torch.train_aux` writes
(`aux_export`). A missing export runs random weights from seed 0 with a
warning, as the JAX scripts do for a missing checkpoint; an orbax
checkpoint raises. The corpus is the reference's `docs/songs`
(`data/corpus_render.CORPUS_ROOT`), or the directory `--corpus` names.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

REPO = Path(__file__).resolve().parents[2]
# Where `python -m etude_tpu_torch.train_aux` writes its exports by default.
AUX_EXPORTS = REPO / "outputs" / "train_aux"


def aux_export(name: str) -> Path:
    """The default export of an aux model (`separator`, `beat_detector`,
    `extractor`) under AUX_EXPORTS."""
    return AUX_EXPORTS / name / "latest"


def refuse_checkpoints(path: Union[str, Path], flag: str) -> Path:
    """`path` resolved; raises when it lies under the repository's
    `checkpoints/`."""
    path = Path(path).resolve()
    if path.is_relative_to((REPO / "checkpoints").resolve()):
        raise ValueError(f"{path} is under checkpoints/, which holds the JAX package's "
                         f"checkpoints; pick another {flag}")
    return path
