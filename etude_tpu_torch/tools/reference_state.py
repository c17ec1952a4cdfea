"""Synthetic reference checkpoints: parameter trees written back in the
reference's state-dict layout, the inverse of `utils/torch_port.py`'s
converters.

No reference weights are in the repository, and the reference's modules
(GPT-NeoX from `transformers`, its hFT and Beat-Transformer classes) are not
installed where the port runs. So the tests and `chip_smoke.py` make a tree
from a seed (`weights.init_*_params_np`), write it here under the names the
reference's modules give their parameters, save it as a user's `.pth` or
`.pkl` would be, and load it back through the loaders.
"""

from __future__ import annotations

import pickle
import sys
import types
from pathlib import Path
from typing import Any, Dict, Union

import numpy as np
import torch

from ..models.decoder import ATTRIBUTE_ORDER, EtudeDecoderConfig
from ..utils.torch_port import ATTR_MODULE

StateDict = Dict[str, torch.Tensor]
# The module of the whole-model pickle's classes: present while it is
# written, absent where it is read, as the reference's own classes are.
_PICKLE_MODULE = "etude_reference_model"


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def decoder_state_dict(params: Dict[str, Any], config: EtudeDecoderConfig) -> StateDict:
    """The decoder tree as the reference EtudeDecoder's state dict
    (embeddings, attribute projection, GPT-NeoX backbone, lm_head)."""
    sd = {"word_embeddings.weight": params["word_emb"],
          "class_embeddings.weight": params["class_emb"],
          "attribute_projection.weight": params["attr_proj"]["w"].T,
          "attribute_projection.bias": params["attr_proj"]["b"],
          "transformer.final_layer_norm.weight": params["final_ln"]["scale"],
          "transformer.final_layer_norm.bias": params["final_ln"]["bias"],
          "lm_head.weight": params["lm_head"].T}
    sd |= {f"{ATTR_MODULE[name]}.weight": params["attr_emb"][name] for name in ATTRIBUTE_ORDER}
    layers = params["layers"]
    for i in range(config.num_hidden_layers):
        p = f"transformer.layers.{i}."
        for ref, (block, key) in {
            "input_layernorm.weight": ("ln1", "scale"),
            "input_layernorm.bias": ("ln1", "bias"),
            "post_attention_layernorm.weight": ("ln2", "scale"),
            "post_attention_layernorm.bias": ("ln2", "bias"),
            "attention.query_key_value.bias": ("qkv", "b"),
            "attention.dense.bias": ("attn_out", "b"),
            "mlp.dense_h_to_4h.bias": ("mlp_in", "b"),
            "mlp.dense_4h_to_h.bias": ("mlp_out", "b"),
        }.items():
            sd[p + ref] = layers[block][key][i]
        for ref, block in {"attention.query_key_value": "qkv", "attention.dense": "attn_out",
                           "mlp.dense_h_to_4h": "mlp_in", "mlp.dense_4h_to_h": "mlp_out"}.items():
            sd[p + ref + ".weight"] = layers[block]["w"][i].T
    return {k: _t(v) for k, v in sd.items()}


def amt_state_dict(params: Dict[str, Any], config) -> StateDict:
    """The hFT tree as the reference Model_SPEC2MIDI's state dict. The
    reference shares one LayerNorm among a layer's sublayers: the tree's
    first slot (`ln1`) is written."""
    enc, dec = "encoder_spec2midi", "decoder_spec2midi"
    sd: Dict[str, Any] = {}

    def lin(prefix, p, i=None):
        w, b = (p["w"], p["b"]) if i is None else (p["w"][i], p["b"][i])
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = w.T, b

    def layer(prefix, block, i, attentions):
        for ref, key in attentions.items():
            for n in "qkvo":
                lin(f"{prefix}.{ref}.fc_{n}", block[key][n], i)
        lin(f"{prefix}.positionwise_feedforward.fc_1", block["ff"]["in"], i)
        lin(f"{prefix}.positionwise_feedforward.fc_2", block["ff"]["out"], i)
        sd[f"{prefix}.layer_norm.weight"] = block["ln1"]["scale"][i]
        sd[f"{prefix}.layer_norm.bias"] = block["ln1"]["bias"][i]

    sd[f"{enc}.conv.weight"] = params["conv"]["w"][:, None, None, :]
    sd[f"{enc}.conv.bias"] = params["conv"]["b"]
    lin(f"{enc}.tok_embedding_freq", params["tok_emb"])
    sd[f"{enc}.pos_embedding_freq.weight"] = params["freq_pos_emb"]
    for i in range(config.encoder_n_layer):
        layer(f"{enc}.layers_freq.{i}", params["enc_layers"], i, {"self_attention": "attn"})
    sd[f"{dec}.pos_embedding_freq.weight"] = params["note_query"]
    layer(f"{dec}.layer_zero_freq", params["dec_zero"], 0, {"encoder_attention": "cross"})
    for i in range(config.decoder_n_layer - 1):
        layer(f"{dec}.layers_freq.{i}", params["dec_layers"], i,
              {"self_attention": "self", "encoder_attention": "cross"})
    sd[f"{dec}.pos_embedding_time.weight"] = params["time_pos_emb"]
    for i in range(config.decoder_n_layer):
        layer(f"{dec}.layers_time.{i}", params["time_layers"], i, {"self_attention": "attn"})
    for branch in ("freq", "time"):
        for name in ("onset", "offset", "mpe", "velocity"):
            lin(f"{dec}.fc_{name}_{branch}", params[f"heads_{branch}"][name])
    return {k: _t(v) for k, v in sd.items()}


def beat_state_dict(params: Dict[str, Any], config) -> StateDict:
    """The Beat-Transformer tree as the reference
    Demixed_DilatedTransformerModel's state dict."""
    sd: Dict[str, Any] = {}

    def lin(name, p):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = p["w"].T, p["b"]

    def ln(name, p):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = p["scale"], p["bias"]

    for name in ("conv1", "conv2", "conv3"):
        sd[f"{name}.weight"] = params[name]["w"].transpose(3, 2, 0, 1)
        sd[f"{name}.bias"] = params[name]["b"]
    for idx, layer in enumerate(params["layers"]):
        t = f"Transformer_layers.time_attention_{idx}"
        for n, ref in (("q", "query"), ("k", "key"), ("v", "value")):
            lin(f"{t}.self_attn.{ref}", layer[n])
        sd[f"{t}.self_attn.Er"] = layer["er"]
        lin(f"{t}.linear1", layer["ff1"])
        lin(f"{t}.linear2", layer["ff2"])
        ln(f"{t}.norm1", layer["ln1"])
        ln(f"{t}.norm2", layer["ln2"])
        if "instr" in layer:
            i, instr = f"Transformer_layers.instr_attention_{idx}", layer["instr"]
            sd[f"{i}.self_attn.in_proj_weight"] = np.concatenate(
                [instr[n]["w"].T for n in "qkv"])
            sd[f"{i}.self_attn.in_proj_bias"] = np.concatenate([instr[n]["b"] for n in "qkv"])
            lin(f"{i}.self_attn.out_proj", instr["o"])
            lin(f"{i}.linear1", instr["ff1"])
            lin(f"{i}.linear2", instr["ff2"])
            ln(f"{i}.norm1", instr["ln1"])
            ln(f"{i}.norm2", instr["ln2"])
    lin("out_linear", params["out"])
    lin("out_linear_t", params["out_tempo"])
    return {k: _t(v) for k, v in sd.items()}


def save_whole_model(state_dict: StateDict, path: Union[str, Path], fmt: str = "pickle") -> None:
    """Writes `state_dict` as a pickled whole model, the form of the
    reference's hFT `latest.pkl`: nested modules of a class whose module the
    reading process lacks, pickled raw (`pickle.dump`, the reference's
    format, fmt "pickle") or by `torch.save` ("zip", or "legacy" for the
    pre-1.6 stream)."""
    module = types.ModuleType(_PICKLE_MODULE)

    class Module(torch.nn.Module):
        pass

    Module.__module__, Module.__qualname__ = _PICKLE_MODULE, "Module"
    module.Module = Module
    root = Module()
    for name, value in state_dict.items():
        *parents, leaf = name.split(".")
        node = root
        for part in parents:
            if part not in node._modules:
                node.add_module(part, Module())
            node = node._modules[part]
        node.register_parameter(leaf, torch.nn.Parameter(value.clone(), requires_grad=False))
    sys.modules[_PICKLE_MODULE] = module
    try:
        if fmt == "pickle":
            with open(path, "wb") as f:
                pickle.dump(root, f)
        else:
            torch.save(root, path, _use_new_zipfile_serialization=fmt == "zip")
    finally:
        del sys.modules[_PICKLE_MODULE]
