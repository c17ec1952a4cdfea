"""Model weights for inference (JAX counterparts:
etude_tpu/utils/model_loader.py:71 for the decoder, the loading branches of
data/extractor.py:162-185, data/separation.py:172-187 and
data/beat_detector.py:309-340).

The committed checkpoints are orbax directories, which only `jax` + `orbax`
can read; the port runs where neither is installed. So an orbax checkpoint
raises, naming the export it would need, and random weights (the JAX
package's `init_params` draws from seed 0, through the weight bridge) are
used only when the checkpoint is missing and the caller allows them.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Tuple, Union

from ..models.decoder import EtudeDecoder, EtudeDecoderConfig
from ..weights import ParamTree, decoder_from_jax, init_decoder_params_np
from .logger import logger


def load_params(what: str, model_path: Union[str, Path, None],
                init_params: Callable[[int], ParamTree],
                allow_random_weights: bool = False) -> ParamTree:
    """A model's parameter tree as numpy arrays: `init_params(0)` when
    `model_path` is missing and random weights are allowed. An existing
    checkpoint raises: orbax cannot be read here, and loading reference
    `.pth`/`.pkl` files is not yet ported."""
    if model_path is not None and Path(model_path).exists():
        if Path(model_path).suffix in (".pth", ".pt", ".pkl"):
            raise NotImplementedError(
                f"{what}: reference torch checkpoints ({model_path}) are not "
                "yet ported to etude_tpu_torch")
        raise RuntimeError(
            f"{what} checkpoint {model_path} is in a format the port cannot "
            "read (orbax needs jax + orbax). Export the parameter tree to a "
            "weight file first; until the repository holds such an export, "
            "real weights run only through the JAX package.")
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
                         allow_random_weights)
    return decoder_from_jax(params, config, device), config
