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
  distill_dataset          the decoder's distillation corpus (etude_e → etude_d
                           pairs tokenized on a beat grid per song: the
                           structuralize chain's tracker grid or the onsets'
                           RGC grid; transposed, re-barred and double-time
                           copies), and the beat-grid helpers the beat
                           scripts share
  eval_distilled           a trained decoder's covers of corpus songs (either
                           engine; oracle, predicted or fixed attributes;
                           teacher-forced history): RGC, IPE, onset F1
  eval_engine_parity       eval_distilled once per engine, and the two
                           engines' covers against each other
  sweep_sampling           RGC and IPE over (temperature, top-p, seed) of the
                           full pipeline's covers, stages 1-2 run once per song
  eval_full_pipeline       the whole `--input` pipeline on rendered corpus
                           songs: RGC and IPE of ours beside the corpus versions
  validate_wpd_audio_path  WPD through the aligner's audio path on rendered
                           corpus songs, against the corpus's wp.json caches
  diagnose_wpd_outliers    where an audio-path warping path leaves the cached
                           one, with proxy and feature (alpha, tuning) ablations

Each keeps its JAX counterpart's arguments, defaults and outputs, with these
differences: an explicit `--device` (default `cuda`; without a GPU it raises
unless `--device cpu` is given) wherever a model runs, and nothing is
written under the repository's `checkpoints/`, which holds the JAX
package's checkpoints, or `checkpoints_torch/`, which holds their exports,
nor, by the decoder-corpus scripts, under
`dataset_distill/` or `validation/` (`refuse_committed`): their outputs
default to paths under `outputs/` or the temporary directory, with names of
their own. Where a JAX script reads the committed orbax
checkpoint of the separator or the beat model, the port's takes the weights
by a flag, `--separator-model` or `--beat-model`: a params-only export,
by default the export of that same committed tree (`PathConfig`'s
`separator_model` and `beat_detector_model`, in `checkpoints_torch/`,
relative to the working directory as every default path of the port's
CLIs), or one that `python -m etude_tpu_torch.train_aux` writes under
AUX_EXPORTS. A missing export runs random weights from seed 0 with a
warning, as the JAX scripts do for a missing checkpoint; an orbax
checkpoint raises. The decoder comes from `--run` (a training run's
`model/` or a published `latest.ckpt`); the full pipeline's weights from the
settings file `--config` names, as in `infer`, with `--allow-random-weights`.
The corpus is the reference's `docs/songs`
(`data/corpus_render.CORPUS_ROOT`), or the directory `--corpus` names.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

REPO = Path(__file__).resolve().parents[2]
OUTPUTS = REPO / "outputs"
# Where `python -m etude_tpu_torch.train_aux` writes its exports by default.
AUX_EXPORTS = OUTPUTS / "train_aux"


# The JAX package's committed outputs, which no script of the port writes.
COMMITTED = ("checkpoints", "dataset_distill", "validation")


def refuse_committed(path: Union[str, Path], flag: str, names=COMMITTED) -> Path:
    """`path` resolved; raises when it lies under one of the repository's
    directories `names`."""
    path = Path(path).resolve()
    for name in names:
        if path.is_relative_to((REPO / name).resolve()):
            raise ValueError(f"{path} is under {name}/, which holds committed files; "
                             f"pick another {flag}")
    return path


def refuse_checkpoints(path: Union[str, Path], flag: str) -> Path:
    """`path` resolved; raises when it lies under the repository's
    `checkpoints/` or `checkpoints_torch/`."""
    return refuse_committed(path, flag, ("checkpoints", "checkpoints_torch"))
