"""Model weights for inference (JAX counterparts:
etude_tpu/utils/model_loader.py:71 for the decoder, the loading branches of
data/extractor.py:162-185, data/separation.py:172-187 and
data/beat_detector.py:60-92).

Three kinds of checkpoint are read:
- a directory in the port's params-only format (`utils/training.py`: a
  `params.npz` of the JAX tree, as `python -m etude_tpu_torch.train`
  exports it), with numpy: the branch of the JAX loader that restores a
  params-only checkpoint (etude_tpu/utils/model_loader.py:93-98);
- the reference's torch files, through `utils/torch_port.py`: `.pth`/`.pt`
  for the decoder and the Beat-Transformer, `.pth`/`.pt`/`.pkl` for the
  hFT transcriber (JAX model_loader.py:85-92, extractor.py:162-170,
  beat_detector.py:60-76);
- none, when the checkpoint is missing and the caller allows random weights
  (the JAX package's `init_params` draws from seed 0, through the weight
  bridge).
The committed checkpoints are orbax directories, which only `jax` + `orbax`
can read; the port runs where neither is installed. So an orbax checkpoint
raises, naming the export it would need.

`remap_decoder_vocab` re-indexes a decoder's tree onto a rebuilt vocabulary
(JAX :16-69), for `scripts/remap_decoder_warmstart.py`.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Callable, Mapping, Optional, Tuple, Union

import numpy as np

from ..models.decoder import EtudeDecoder, EtudeDecoderConfig
from ..weights import ParamTree, decoder_from_jax, init_decoder_params_np
from .logger import logger
from .torch_port import load_torch_decoder_checkpoint
from .training import is_params_dir, load_params_only


def _nearest_token_id(token: str, token_to_id: dict) -> Optional[int]:
    """ID of the same-type token with the closest numeric value (the vocab
    gains Note_103 → borrow Note_102's rows), or None (JAX :16)."""
    m = re.match(r"^([A-Za-z]+)_(-?\d+)$", token)
    if not m:
        return None
    type_, value = m.group(1), int(m.group(2))
    best, best_dist = None, None
    for tok, tid in token_to_id.items():
        m2 = re.match(r"^([A-Za-z]+)_(-?\d+)$", tok)
        if not m2 or m2.group(1) != type_:
            continue
        dist = abs(int(m2.group(2)) - value)
        if best_dist is None or dist < best_dist:
            best, best_dist = tid, dist
    return best


def remap_decoder_vocab(params: ParamTree, old_vocab, new_vocab) -> ParamTree:
    """Re-index `word_emb` rows and `lm_head` columns of a decoder tree in
    the JAX layout from one vocabulary to another by token string, so a
    trained checkpoint can warm-start training against a rebuilt vocab whose
    IDs shifted or grew (JAX :35). Tokens absent from the old vocab inherit
    the nearest same-type token's weights (Note_103 ← Note_102); a token
    with no such neighbour gets zeros. Leaf dtypes are kept."""
    old_map = dict(old_vocab.token_to_id)
    new_map = dict(new_vocab.token_to_id)
    old_word = np.asarray(params["word_emb"])
    old_head = np.asarray(params["lm_head"])
    V_new, H = len(new_map), old_word.shape[1]

    word = np.zeros((V_new, H), old_word.dtype)
    head = np.zeros((old_head.shape[0], V_new), old_head.dtype)
    borrowed = []
    for tok, nid in new_map.items():
        oid = old_map.get(tok)
        if oid is None:
            oid = _nearest_token_id(tok, old_map)
            borrowed.append((tok, oid))
        if oid is not None:
            word[nid] = old_word[oid]
            head[:, nid] = old_head[:, oid]
    if borrowed:
        logger.info(
            "vocab remap: borrowed weights for "
            + ", ".join(f"{t}←id{o}" for t, o in borrowed)
        )
    out = dict(params)
    out["word_emb"] = word
    out["lm_head"] = head
    return out


def load_params(what: str, model_path: Union[str, Path, None],
                init_params: Callable[[int], ParamTree],
                allow_random_weights: bool = False,
                reference: Optional[Mapping[str, Callable[[Path], ParamTree]]] = None,
                ) -> ParamTree:
    """A model's parameter tree as numpy arrays: from a reference torch file
    whose suffix `reference` maps to its loader, from a params-only export,
    or `init_params(0)` when `model_path` is missing and random weights are
    allowed. Any other checkpoint raises: orbax cannot be read here."""
    if model_path is not None and Path(model_path).exists():
        load_reference = (reference or {}).get(Path(model_path).suffix)
        if load_reference is not None:
            logger.info(f"{what}: reference torch checkpoint ported from {model_path}")
            return load_reference(Path(model_path))
        if is_params_dir(model_path):
            logger.debug(f"{what} weights loaded from {model_path}")
            return load_params_only(model_path)
        raise RuntimeError(
            f"{what} checkpoint {model_path} is in a format the port cannot "
            "read (orbax needs jax + orbax). Export the parameter tree into "
            "the port's params-only format (a directory holding params.npz, "
            "etude_tpu_torch/utils/training.py) first; until the repository "
            "holds such an export, real weights run only through the JAX "
            "package.")
    if not allow_random_weights:
        raise FileNotFoundError(
            f"{what} checkpoint {model_path} not found; pass "
            "allow_random_weights=True (--allow-random-weights) to run with "
            "random weights")
    logger.warn(f"{what}: running with RANDOM weights ({model_path} missing)")
    return init_params(0)


def load_etude_decoder(
    config_path: Union[str, Path],
    model_path: Union[str, Path],
    device="cuda",
    allow_random_weights: bool = False,
) -> Tuple[EtudeDecoder, EtudeDecoderConfig]:
    """Returns (model, config), the model in eval mode on `device`."""
    config_path, model_path = Path(config_path), Path(model_path)
    if config_path.exists():
        config = EtudeDecoderConfig.from_json_file(config_path)
    else:
        logger.warn(f"decoder config {config_path} not found; using defaults")
        config = EtudeDecoderConfig()

    params = load_params("decoder", model_path,
                         lambda seed: init_decoder_params_np(config, seed),
                         allow_random_weights,
                         reference=dict.fromkeys(
                             (".pth", ".pt"),
                             lambda path: load_torch_decoder_checkpoint(path, config)))
    return decoder_from_jax(params, config, device), config
