"""The weight bridge: the JAX package's parameter trees, as numpy arrays,
into the port's modules.

Decoder: the JAX tree (etude_tpu/models/decoder.py:83-141) stacks the layers
along a leading [L] axis, stores matrices as [in, out] and keeps an untied
`lm_head` [hidden, vocab]. `decoder_from_jax` unstacks and transposes into
PyTorch's [out, in] `nn.Linear` weights, so both packages compute the same
function.

Beat-Transformer and separator (etude_tpu/models/beat_transformer.py:51,
separator.py:56): matrices [in, out] → [out, in]; conv kernels HWIO →
PyTorch's OIHW.

hFT transcriber (etude_tpu/models/amt.py:64-130): the `[L]`-stacked
`enc_layers`, `dec_layers` and `time_layers` are unstacked into per-layer
modules, matrices [in, out] → [out, in]; the front-end conv and token
embedding are kept as they are and folded per call, as in the JAX forward.

Each `init_*_params_np` is the port's own numpy copy of the JAX package's
`init_params` (same tree, same draws in the same order), so full-width
weights can be made from a seed without JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .models.amt import HFT, AMTConfig
from .models.beat_transformer import BeatTransformer, BeatTransformerConfig
from .models.decoder import ATTRIBUTE_ORDER, EtudeDecoder, EtudeDecoderConfig
from .models.separator import Separator, SeparatorConfig, _stage_channels

ParamTree = Dict[str, Any]


def init_decoder_params_np(config: EtudeDecoderConfig, seed: int = 0) -> ParamTree:
    """The JAX package's `init_params(config, seed)` in numpy, f32."""
    rng = np.random.default_rng(seed)
    std = config.initializer_range
    H, L = config.hidden_size, config.num_hidden_layers
    I, V = config.intermediate_size, config.vocab_size
    A = config.attribute_emb_dim

    def normal(*shape):
        return rng.normal(0.0, std, size=shape).astype(np.float32)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    word_emb = normal(V, H)
    class_emb = normal(config.num_classes, H)
    attr_emb = {name: normal(config.num_attribute_bins, A)
                for name in ATTRIBUTE_ORDER}
    word_emb[config.pad_token_id] = 0.0
    class_emb[config.pad_class_id] = 0.0
    for e in attr_emb.values():
        e[config.attribute_pad_id] = 0.0

    return {
        "word_emb": word_emb,
        "class_emb": class_emb,
        "attr_emb": attr_emb,
        "attr_proj": {"w": normal(len(ATTRIBUTE_ORDER) * A, H), "b": zeros(H)},
        "layers": {
            "ln1": {"scale": ones(L, H), "bias": zeros(L, H)},
            "ln2": {"scale": ones(L, H), "bias": zeros(L, H)},
            "qkv": {"w": normal(L, H, 3 * H), "b": zeros(L, 3 * H)},
            "attn_out": {"w": normal(L, H, H), "b": zeros(L, H)},
            "mlp_in": {"w": normal(L, H, I), "b": zeros(L, I)},
            "mlp_out": {"w": normal(L, I, H), "b": zeros(L, H)},
        },
        "final_ln": {"scale": ones(H), "bias": zeros(H)},
        "lm_head": normal(H, V),
    }


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


@torch.no_grad()
def decoder_from_jax(params: ParamTree, config: EtudeDecoderConfig,
                     device="cpu") -> EtudeDecoder:
    """Build the port's decoder (f32 masters, eval mode) from the JAX tree.
    Leaves may be numpy arrays or anything `np.asarray` reads."""
    model = EtudeDecoder(config)
    model.word_emb.weight.copy_(_t(params["word_emb"]))
    model.class_emb.weight.copy_(_t(params["class_emb"]))
    for name in ATTRIBUTE_ORDER:
        model.attr_emb[name].weight.copy_(_t(params["attr_emb"][name]))
    model.attr_proj.weight.copy_(_t(params["attr_proj"]["w"]).T)
    model.attr_proj.bias.copy_(_t(params["attr_proj"]["b"]))

    stacked = params["layers"]
    for l, layer in enumerate(model.layers):
        for ln in ("ln1", "ln2"):
            getattr(layer, ln).weight.copy_(_t(stacked[ln]["scale"][l]))
            getattr(layer, ln).bias.copy_(_t(stacked[ln]["bias"][l]))
        for lin in ("qkv", "attn_out", "mlp_in", "mlp_out"):
            getattr(layer, lin).weight.copy_(_t(stacked[lin]["w"][l]).T)
            getattr(layer, lin).bias.copy_(_t(stacked[lin]["b"][l]))

    model.final_ln.weight.copy_(_t(params["final_ln"]["scale"]))
    model.final_ln.bias.copy_(_t(params["final_ln"]["bias"]))
    model.lm_head.weight.copy_(_t(params["lm_head"]).T)
    return model.to(device).eval().requires_grad_(False)


def init_beat_params_np(config: BeatTransformerConfig, seed: int = 0,
                        std: float = 0.02) -> ParamTree:
    """The JAX package's Beat-Transformer `init_params(config, seed, std)`
    in numpy, f32."""
    rng = np.random.default_rng(seed)
    D, Hid = config.dmodel, config.d_hid

    def normal(*shape):
        return rng.normal(0.0, std, size=shape).astype(np.float32)

    def linear(i, o):
        return {"w": normal(i, o), "b": np.zeros(o, np.float32)}

    def ln():
        return {"scale": np.ones(D, np.float32), "bias": np.zeros(D, np.float32)}

    layers = []
    for idx in range(config.nlayers):
        layer = {
            "q": linear(D, D), "k": linear(D, D), "v": linear(D, D),
            "er": normal(config.nhead, D // config.nhead, config.attn_len),
            "ff1": linear(D, Hid), "ff2": linear(Hid, D),
            "ln1": ln(), "ln2": ln(),
        }
        if idx in config.instr_layers:
            layer["instr"] = {
                "q": linear(D, D), "k": linear(D, D), "v": linear(D, D),
                "o": linear(D, D),
                "ff1": linear(D, Hid), "ff2": linear(Hid, D),
                "ln1": ln(), "ln2": ln(),
            }
        layers.append(layer)
    return {
        "conv1": {"w": normal(5, 3, 1, 32), "b": np.zeros(32, np.float32)},
        "conv2": {"w": normal(1, 12, 32, 64), "b": np.zeros(64, np.float32)},
        "conv3": {"w": normal(3, 6, 64, D), "b": np.zeros(D, np.float32)},
        "layers": layers,
        "out": linear(D, config.ntoken),
        "out_tempo": linear(D, config.n_tempi),
    }


def init_separator_params_np(config: SeparatorConfig, seed: int = 0,
                             std: float = 0.02) -> ParamTree:
    """The JAX package's separator `init_params(config, seed, std)` in numpy,
    f32."""
    rng = np.random.default_rng(seed)
    k = config.kernel

    def conv(ci, co, norm=True):
        p = {"w": rng.normal(0.0, std, size=(k, k, ci, co)).astype(np.float32),
             "b": np.zeros(co, np.float32)}
        if norm:
            p["gn_scale"] = np.ones(co, np.float32)
            p["gn_bias"] = np.zeros(co, np.float32)
        return p

    chans = _stage_channels(config)
    enc, dec = [], []
    ch = 1
    for co in chans:
        enc.append({"down": conv(ch, 2 * co), "ref": conv(co, 2 * co)})
        ch = co
    for i in reversed(range(config.depth)):
        co = chans[i - 1] if i > 0 else config.base_channels
        skip_ch = chans[i - 1] if i > 0 else 1
        dec.append({"up": conv(ch, 2 * ch), "merge": conv(ch + skip_ch, 2 * co)})
        ch = co
    return {"enc": enc, "dec": dec,
            "mask_head": conv(ch, config.num_stems, norm=False)}


def _copy_linear(lin, p):
    lin.weight.copy_(_t(p["w"]).T)
    lin.bias.copy_(_t(p["b"]))


def _copy_ln(ln, p):
    ln.weight.copy_(_t(p["scale"]))
    ln.bias.copy_(_t(p["bias"]))


def _copy_conv(conv, p):
    conv.weight.copy_(_t(p["w"]).permute(3, 2, 0, 1))     # HWIO → OIHW
    conv.bias.copy_(_t(p["b"]))


@torch.no_grad()
def beat_transformer_from_jax(params: ParamTree, config: BeatTransformerConfig,
                              device="cpu") -> BeatTransformer:
    """Build the port's Beat-Transformer (f32 masters, eval mode) from the
    JAX tree."""
    model = BeatTransformer(config)
    for name in ("conv1", "conv2", "conv3"):
        _copy_conv(getattr(model, name), params[name])
    for layer, p in zip(model.layers, params["layers"], strict=True):
        for name in ("q", "k", "v", "ff1", "ff2"):
            _copy_linear(getattr(layer, name), p[name])
        _copy_ln(layer.ln1, p["ln1"])
        _copy_ln(layer.ln2, p["ln2"])
        layer.er.copy_(_t(p["er"]))
        if layer.instr is not None:
            for name in ("q", "k", "v", "o", "ff1", "ff2"):
                _copy_linear(getattr(layer.instr, name), p["instr"][name])
            _copy_ln(layer.instr.ln1, p["instr"]["ln1"])
            _copy_ln(layer.instr.ln2, p["instr"]["ln2"])
    _copy_linear(model.out, params["out"])
    _copy_linear(model.out_tempo, params["out_tempo"])
    return model.to(device).eval().requires_grad_(False)


@torch.no_grad()
def separator_from_jax(params: ParamTree, config: SeparatorConfig,
                       device="cpu") -> Separator:
    """Build the port's separator U-Net (f32 masters, eval mode) from the
    JAX tree."""
    model = Separator(config)

    def copy(module, p):
        _copy_conv(module.conv, p)
        if module.norm:
            module.gn_scale.copy_(_t(p["gn_scale"]))
            module.gn_bias.copy_(_t(p["gn_bias"]))

    for stage, p in zip(model.enc, params["enc"], strict=True):
        copy(stage["down"], p["down"])
        copy(stage["ref"], p["ref"])
    for stage, p in zip(model.dec, params["dec"], strict=True):
        copy(stage["up"], p["up"])
        copy(stage["merge"], p["merge"])
    copy(model.mask_head, params["mask_head"])
    return model.to(device).eval().requires_grad_(False)


def init_amt_params_np(config: AMTConfig, seed: int = 0, std: float = 0.02) -> ParamTree:
    """The JAX package's hFT `init_params(config, seed, std)` in numpy, f32."""
    rng = np.random.default_rng(seed)
    H, P = config.hid_dim, config.pf_dim

    def normal(*shape):
        return rng.normal(0.0, std, size=shape).astype(np.float32)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    def attn(n):
        return {name: {"w": normal(n, H, H), "b": zeros(n, H)} for name in "qkvo"}

    def ff(n):
        return {"in": {"w": normal(n, H, P), "b": zeros(n, P)},
                "out": {"w": normal(n, P, H), "b": zeros(n, H)}}

    def ln(n):
        return {"scale": ones(n, H), "bias": zeros(n, H)}

    def enc_stack(n):
        return {"attn": attn(n), "ff": ff(n), "ln1": ln(n), "ln2": ln(n)}

    def heads():
        return {name: {"w": normal(H, 1), "b": zeros(1)} for name in ("onset", "offset", "mpe")
                } | {"velocity": {"w": normal(H, config.n_velocity), "b": zeros(config.n_velocity)}}

    n_dec = config.decoder_n_layer - 1  # layer zero is separate
    return {
        "conv": {"w": normal(config.cnn_channel, config.cnn_kernel),
                 "b": zeros(config.cnn_channel)},
        "tok_emb": {"w": normal(config.cnn_dim, H), "b": zeros(H)},
        "freq_pos_emb": normal(config.n_bin, H),
        "enc_layers": enc_stack(config.encoder_n_layer),
        "note_query": normal(config.n_note, H),
        "dec_zero": {"cross": attn(1), "ff": ff(1), "ln1": ln(1), "ln2": ln(1)},
        "dec_layers": {"self": attn(n_dec), "cross": attn(n_dec), "ff": ff(n_dec),
                       "ln1": ln(n_dec), "ln2": ln(n_dec), "ln3": ln(n_dec)},
        "heads_freq": heads(),
        "time_pos_emb": normal(config.n_frame, H),
        "time_layers": enc_stack(config.decoder_n_layer),
        "heads_time": heads(),
    }


def _layer(tree, l):
    """Layer `l` of an [L]-stacked subtree."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return np.asarray(tree)[l]


@torch.no_grad()
def amt_from_jax(params: ParamTree, config: AMTConfig, device="cpu") -> HFT:
    """Build the port's hFT transcriber (f32 masters, eval mode) from the
    JAX tree. `time_pos_emb` may be longer than `config.n_frame` (a
    checkpoint trained at 512-frame segments run at fewer frames)."""
    model = HFT(config, n_time_pos=len(params["time_pos_emb"]))
    model.conv_w.copy_(_t(params["conv"]["w"]))
    model.conv_b.copy_(_t(params["conv"]["b"]))
    _copy_linear(model.tok_emb, params["tok_emb"])
    model.freq_pos_emb.copy_(_t(params["freq_pos_emb"]))
    model.note_query.copy_(_t(params["note_query"]))
    model.time_pos_emb.copy_(_t(params["time_pos_emb"]))

    def attention(module, p):
        for name in "qkvo":
            _copy_linear(getattr(module, name), p[name])

    def feed_forward(module, p):
        _copy_linear(module.inp, p["in"])
        _copy_linear(module.out, p["out"])

    def norms(module, p, names):
        for ln, name in zip(module.ln, names, strict=True):
            _copy_ln(ln, p[name])

    for stack, layers in (("enc_layers", model.enc_layers), ("time_layers", model.time_layers)):
        for l, layer in enumerate(layers):
            p = _layer(params[stack], l)
            attention(layer.attn, p["attn"])
            feed_forward(layer.ff, p["ff"])
            norms(layer, p, ("ln1", "ln2"))
    zero = _layer(params["dec_zero"], 0)
    attention(model.dec_zero.cross, zero["cross"])
    feed_forward(model.dec_zero.ff, zero["ff"])
    norms(model.dec_zero, zero, ("ln1", "ln2"))
    for l, layer in enumerate(model.dec_layers):
        p = _layer(params["dec_layers"], l)
        attention(layer.self_attn, p["self"])
        attention(layer.cross, p["cross"])
        feed_forward(layer.ff, p["ff"])
        norms(layer, p, ("ln1", "ln2", "ln3"))
    for heads, p in ((model.heads_freq, params["heads_freq"]),
                     (model.heads_time, params["heads_time"])):
        for name in ("onset", "offset", "mpe", "velocity"):
            _copy_linear(getattr(heads, name), p[name])
    return model.to(device).eval().requires_grad_(False)
