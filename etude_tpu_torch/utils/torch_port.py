"""Reference PyTorch checkpoints → the JAX package's parameter trees, as numpy
arrays (the port's own copy of etude_tpu/utils/torch_port.py, without jax).

The reference ships its trained weights as torch files: the decoder and the
Beat-Transformer as `.pth` state dicts, the hFT transcriber as a `.pth`
state dict or a pickled whole model (`.pkl`). Each converter maps such a
state dict onto the tree the JAX package's models take, which the weight
bridge (`weights.py` `*_from_jax`) turns into the port's modules.

Layout notes (JAX module docstring):
  * torch Linear stores [out, in]; the tree holds [in, out];
  * GPT-NeoX packs query_key_value per head as [heads, (q, k, v), head_dim],
    the decoder's own reshape-and-split, so the packed matrix transposes
    straight across;
  * `_orig_mod.` prefixes (torch.compile artifacts) are stripped, as the
    reference loader does.
"""

from __future__ import annotations

import io
import pickle
from pathlib import Path
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from ..models.decoder import ATTRIBUTE_ORDER, EtudeDecoderConfig
from .logger import logger

# Reference embedding-module name per attribute (concatenation order is
# ATTRIBUTE_ORDER: pitch_overlap, polyphony, sustain, rhythm_intensity).
ATTR_MODULE = {
    "pitch_overlap": "pitch_overlap_embeddings",
    "polyphony": "polyphony_embeddings",
    "sustain": "note_sustain_embeddings",
    "rhythm_intensity": "rhythm_intensity_embeddings",
}


def _to_np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def _getter(state_dict: Mapping[str, Any]):
    sd = {k.replace("_orig_mod.", ""): v for k, v in state_dict.items()}
    return lambda name: _to_np(sd[name])


def convert_etude_decoder_state_dict(state_dict: Mapping[str, Any],
                                     config: EtudeDecoderConfig) -> Dict[str, Any]:
    """Torch EtudeDecoder state dict → the decoder tree (JAX :43)."""
    get = _getter(state_dict)
    L = config.num_hidden_layers

    def stack(fmt, transpose=False):
        mats = [get(fmt.format(i)) for i in range(L)]
        return np.stack([m.T for m in mats] if transpose else mats)

    layer = "transformer.layers.{}."
    return {
        "word_emb": get("word_embeddings.weight"),
        "class_emb": get("class_embeddings.weight"),
        "attr_emb": {name: get(f"{ATTR_MODULE[name]}.weight") for name in ATTRIBUTE_ORDER},
        "attr_proj": {"w": get("attribute_projection.weight").T,
                      "b": get("attribute_projection.bias")},
        "layers": {
            "ln1": {"scale": stack(layer + "input_layernorm.weight"),
                    "bias": stack(layer + "input_layernorm.bias")},
            "ln2": {"scale": stack(layer + "post_attention_layernorm.weight"),
                    "bias": stack(layer + "post_attention_layernorm.bias")},
            "qkv": {"w": stack(layer + "attention.query_key_value.weight", True),
                    "b": stack(layer + "attention.query_key_value.bias")},
            "attn_out": {"w": stack(layer + "attention.dense.weight", True),
                         "b": stack(layer + "attention.dense.bias")},
            "mlp_in": {"w": stack(layer + "mlp.dense_h_to_4h.weight", True),
                       "b": stack(layer + "mlp.dense_h_to_4h.bias")},
            "mlp_out": {"w": stack(layer + "mlp.dense_4h_to_h.weight", True),
                        "b": stack(layer + "mlp.dense_4h_to_h.bias")},
        },
        "final_ln": {"scale": get("transformer.final_layer_norm.weight"),
                     "bias": get("transformer.final_layer_norm.bias")},
        "lm_head": get("lm_head.weight").T,
    }


def _state_dict_payload(path: Union[str, Path], *keys: str) -> Mapping[str, Any]:
    payload = torch.load(path, map_location="cpu", weights_only=True)
    for key in keys:
        if key in payload:
            return payload[key]
    return payload


def load_torch_decoder_checkpoint(path: Union[str, Path],
                                  config: EtudeDecoderConfig) -> Dict[str, Any]:
    """A reference decoder `.pth` → the decoder tree (JAX :120)."""
    state_dict = _state_dict_payload(path, "model_state_dict")
    logger.info(f"converting torch checkpoint ({len(state_dict)} tensors)")
    return convert_etude_decoder_state_dict(state_dict, config)


# =============================================================== AMT / hFT
def convert_amt_state_dict(state_dict: Mapping[str, Any], config) -> Dict[str, Any]:
    """Torch Model_SPEC2MIDI state dict → the hFT tree (JAX :134).

    Each reference EncoderLayer/DecoderLayer applies ONE shared LayerNorm
    after every sublayer; the tree keeps a slot per sublayer, so the shared
    tensors are copied into each slot."""
    get = _getter(state_dict)

    def lin(prefix):
        return {"w": get(f"{prefix}.weight").T, "b": get(f"{prefix}.bias")}

    def lin_stack(fmt, n):
        return {"w": np.stack([get(fmt.format(i) + ".weight").T for i in range(n)]),
                "b": np.stack([get(fmt.format(i) + ".bias") for i in range(n)])}

    def ln_stack(fmt, n):
        return {"scale": np.stack([get(fmt.format(i) + ".weight") for i in range(n)]),
                "bias": np.stack([get(fmt.format(i) + ".bias") for i in range(n)])}

    def attn_stack(fmt, n):
        return {p: lin_stack(fmt + f".fc_{p}", n) for p in ("q", "k", "v", "o")}

    def ff_stack(fmt, n):
        return {"in": lin_stack(fmt + ".fc_1", n), "out": lin_stack(fmt + ".fc_2", n)}

    def copy(ln):
        return {k: v.copy() for k, v in ln.items()}

    enc, dec = "encoder_spec2midi", "decoder_spec2midi"
    n_enc = config.encoder_n_layer
    n_dec = config.decoder_n_layer - 1  # layer zero is separate
    n_time = config.decoder_n_layer
    enc_ln = ln_stack(f"{enc}.layers_freq.{{}}.layer_norm", n_enc)
    dec_ln = ln_stack(f"{dec}.layers_freq.{{}}.layer_norm", n_dec)
    zero_ln = {"scale": get(f"{dec}.layer_zero_freq.layer_norm.weight")[None],
               "bias": get(f"{dec}.layer_zero_freq.layer_norm.bias")[None]}
    time_ln = ln_stack(f"{dec}.layers_time.{{}}.layer_norm", n_time)

    def heads(branch):
        return {name: lin(f"{dec}.fc_{name}_{branch}")
                for name in ("onset", "offset", "mpe", "velocity")}

    return {
        # torch Conv2d(1 → C, (1, K)) weight [C, 1, 1, K] → [C, K].
        "conv": {"w": get(f"{enc}.conv.weight")[:, 0, 0, :], "b": get(f"{enc}.conv.bias")},
        "tok_emb": lin(f"{enc}.tok_embedding_freq"),
        "freq_pos_emb": get(f"{enc}.pos_embedding_freq.weight"),
        "enc_layers": {
            "attn": attn_stack(f"{enc}.layers_freq.{{}}.self_attention", n_enc),
            "ff": ff_stack(f"{enc}.layers_freq.{{}}.positionwise_feedforward", n_enc),
            "ln1": enc_ln, "ln2": copy(enc_ln),
        },
        "note_query": get(f"{dec}.pos_embedding_freq.weight"),
        "dec_zero": {
            "cross": attn_stack(f"{dec}.layer_zero_freq.encoder_attention", 1),
            "ff": ff_stack(f"{dec}.layer_zero_freq.positionwise_feedforward", 1),
            "ln1": zero_ln, "ln2": copy(zero_ln),
        },
        "dec_layers": {
            "self": attn_stack(f"{dec}.layers_freq.{{}}.self_attention", n_dec),
            "cross": attn_stack(f"{dec}.layers_freq.{{}}.encoder_attention", n_dec),
            "ff": ff_stack(f"{dec}.layers_freq.{{}}.positionwise_feedforward", n_dec),
            "ln1": dec_ln, "ln2": copy(dec_ln), "ln3": copy(dec_ln),
        },
        "heads_freq": heads("freq"),
        "time_pos_emb": get(f"{dec}.pos_embedding_time.weight"),
        "time_layers": {
            "attn": attn_stack(f"{dec}.layers_time.{{}}.self_attention", n_time),
            "ff": ff_stack(f"{dec}.layers_time.{{}}.positionwise_feedforward", n_time),
            "ln1": time_ln, "ln2": copy(time_ln),
        },
        "heads_time": heads("time"),
    }


# ========================================================= Beat-Transformer
def convert_beat_state_dict(state_dict: Mapping[str, Any], config) -> Dict[str, Any]:
    """Torch Demixed_DilatedTransformerModel state dict → the
    Beat-Transformer tree (JAX :245): conv weights OIHW → HWIO, no output
    projection in the dilated layers, the instrument layers' packed
    in_proj split into q, k, v."""
    get = _getter(state_dict)

    def conv(name):
        return {"w": get(f"{name}.weight").transpose(2, 3, 1, 0), "b": get(f"{name}.bias")}

    def lin(name):
        return {"w": get(f"{name}.weight").T, "b": get(f"{name}.bias")}

    def ln(name):
        return {"scale": get(f"{name}.weight"), "bias": get(f"{name}.bias")}

    layers = []
    for idx in range(config.nlayers):
        t = f"Transformer_layers.time_attention_{idx}"
        layer = {
            "q": lin(f"{t}.self_attn.query"),
            "k": lin(f"{t}.self_attn.key"),
            "v": lin(f"{t}.self_attn.value"),
            "er": get(f"{t}.self_attn.Er"),
            "ff1": lin(f"{t}.linear1"),
            "ff2": lin(f"{t}.linear2"),
            "ln1": ln(f"{t}.norm1"),
            "ln2": ln(f"{t}.norm2"),
        }
        if idx in config.instr_layers:
            i = f"Transformer_layers.instr_attention_{idx}"
            in_w = get(f"{i}.self_attn.in_proj_weight")  # [3D, D]
            in_b = get(f"{i}.self_attn.in_proj_bias")    # [3D]
            D = in_w.shape[1]
            layer["instr"] = {
                **{name: {"w": in_w[j * D:(j + 1) * D].T, "b": in_b[j * D:(j + 1) * D]}
                   for j, name in enumerate("qkv")},
                "o": lin(f"{i}.self_attn.out_proj"),
                "ff1": lin(f"{i}.linear1"),
                "ff2": lin(f"{i}.linear2"),
                "ln1": ln(f"{i}.norm1"),
                "ln2": ln(f"{i}.norm2"),
            }
        layers.append(layer)
    return {
        "conv1": conv("conv1"), "conv2": conv("conv2"), "conv3": conv("conv3"),
        "layers": layers,
        "out": lin("out_linear"),
        "out_tempo": lin("out_linear_t"),
    }


# ================================================== pickled hFT model files
def load_hft_pickle_state_dict(path: Union[str, Path]) -> Dict[str, Any]:
    """The state dict of a reference pickled-whole-model file (`latest.pkl`,
    JAX :317). Whatever module classes the pickle names and this process
    lacks become stub `torch.nn.Module` subclasses: a module's state lives
    in its `__dict__`, so `state_dict()` works without the reference's
    source.

    Reads the three whole-model formats: a raw `pickle.dump(model)` (whose
    tensors embed `torch.save` blobs, read through
    `torch.storage._load_from_bytes`), a `torch.save` zip archive and a
    pre-1.6 `torch.save` stream (both through `torch.load` with the stub
    unpickler). Like the reference's own loader, this unpickles the file:
    read only files from a source you trust."""
    stubs: Dict[str, type] = {}

    class _StubUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module == "torch.storage" and name == "_load_from_bytes":
                return lambda b: torch.load(io.BytesIO(b), map_location="cpu",
                                            weights_only=True)
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                key = f"{module}.{name}"
                if key not in stubs:
                    stubs[key] = type(name, (torch.nn.Module,), {})
                return stubs[key]

    class _ShimPickleModule:
        """A pickle-module facade `torch.load` accepts, with the stub
        unpickler, so torch restores the storages of both archive
        formats."""
        Unpickler = _StubUnpickler

        @staticmethod
        def load(f, **kw):
            return _StubUnpickler(f, **kw).load()

        @staticmethod
        def loads(b, **kw):
            return _StubUnpickler(io.BytesIO(b), **kw).load()

    try:
        model = torch.load(path, map_location="cpu", weights_only=False,
                           pickle_module=_ShimPickleModule)
    except (pickle.UnpicklingError, RuntimeError, EOFError, KeyError):
        # Not a torch.save artifact: a raw pickle.dump(model), the format
        # the reference's own loader expects.
        with open(path, "rb") as f:
            model = _StubUnpickler(f).load()
    if hasattr(model, "state_dict"):
        return model.state_dict()
    if isinstance(model, Mapping):
        return dict(model)
    raise ValueError(f"unsupported pickle payload: {type(model)}")


def load_torch_amt_checkpoint(path: Union[str, Path], config) -> Dict[str, Any]:
    """A reference hFT checkpoint (`.pth` state dict or `.pkl` whole model)
    → the hFT tree (JAX :384)."""
    if str(path).endswith(".pkl"):
        state_dict = load_hft_pickle_state_dict(path)
    else:
        state_dict = _state_dict_payload(path, "model_state_dict")
    logger.info(f"converting torch AMT checkpoint ({len(state_dict)} tensors)")
    return convert_amt_state_dict(state_dict, config)


def load_torch_beat_checkpoint(path: Union[str, Path], config) -> Dict[str, Any]:
    """A reference Beat-Transformer `.pth` → the Beat-Transformer tree (JAX
    :401)."""
    state_dict = _state_dict_payload(path, "state_dict", "model_state_dict")
    logger.info(f"converting torch beat checkpoint ({len(state_dict)} tensors)")
    return convert_beat_state_dict(state_dict, config)
