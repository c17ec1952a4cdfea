"""The weight bridge: the JAX package's parameter trees, as numpy arrays,
into the port's modules, and back.

Every model has a table of leaves (`_decoder_leaves`, `_beat_leaves`,
`_separator_leaves`, `_amt_leaves`): each PyTorch parameter name with its
path in the JAX tree (dict keys, and list indices where the JAX tree holds a
list of layers), its index in an `[L]`-stacked leaf, and its layout. One
pair of functions reads every table both ways, so each `*_to_jax` is the
exact inverse of its `*_from_jax`; the same tables carry gradients and Adam
moments, shaped like the parameters, into the JAX tree.

- Decoder (etude_tpu/models/decoder.py:83-141): layers stacked along a
  leading [L] axis, matrices [in, out] (PyTorch's `nn.Linear` holds
  [out, in]), an untied `lm_head` [hidden, vocab].
- Beat-Transformer and separator (etude_tpu/models/beat_transformer.py:51,
  separator.py:56): lists of layer dicts; matrices [in, out]; conv kernels
  HWIO (PyTorch: OIHW).
- hFT transcriber (etude_tpu/models/amt.py:64-130): `[L]`-stacked
  `enc_layers`, `dec_layers` and `time_layers` (and `dec_zero`, stacked
  [1]); matrices [in, out]; the front-end conv and token embedding as they
  are, folded per call as in the JAX forward.

Each `init_*_params_np` is the port's own numpy copy of the JAX package's
`init_params` (same tree, same draws in the same order), so full-width
weights can be made from a seed without JAX.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

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


# (PyTorch name, JAX path, index in an [L]-stacked leaf or None, layout):
# layout "same", "linear" ([in, out] ↔ [out, in]) or "conv" (HWIO ↔ OIHW).
Leaf = Tuple[str, Tuple[Any, ...], Optional[int], str]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _to_torch_layout(t: torch.Tensor, layout: str) -> torch.Tensor:
    if layout == "linear":
        return t.T.contiguous()
    if layout == "conv":
        return t.permute(3, 2, 0, 1).contiguous()
    return t


def _to_jax_layout(t: torch.Tensor, layout: str) -> torch.Tensor:
    if layout == "linear":
        return t.T
    if layout == "conv":
        return t.permute(2, 3, 1, 0)
    return t


def state_from_tree(params: ParamTree, leaves: List[Leaf]) -> Dict[str, torch.Tensor]:
    """A JAX tree (leaves: numpy arrays or anything `np.asarray` reads) as
    f32 CPU tensors under the PyTorch names of `leaves`."""
    state = {}
    for name, path, layer, layout in leaves:
        a = params
        for key in path:
            a = a[key]
        state[name] = _to_torch_layout(_t(a if layer is None else np.asarray(a)[layer]), layout)
    return state


def rebuild_lists(node):
    """Dicts keyed 0..n-1 → lists, at every depth: the list indices of a
    JAX path, as ints or as their decimal digits (the JAX trees name no
    dict key with digits)."""
    if not isinstance(node, dict):
        return node
    node = {k: rebuild_lists(v) for k, v in node.items()}
    if node and all(str(k).isdigit() for k in node):
        index = {int(k): v for k, v in node.items()}
        if sorted(index) != list(range(len(index))):
            raise ValueError(f"list indices {sorted(index)} are not 0..{len(index) - 1}")
        return [index[i] for i in range(len(index))]
    return node


def tree_from_state(state: Dict[str, torch.Tensor], leaves: List[Leaf]) -> ParamTree:
    """Tensors under the PyTorch names of `leaves` (parameters, or anything
    shaped like them) → the JAX tree as numpy arrays; the inverse of
    `state_from_tree`."""
    flat: Dict[Tuple[Any, ...], Any] = {}
    for name, path, layer, layout in leaves:
        a = _to_jax_layout(state[name].detach().cpu(), layout).numpy().copy()
        if layer is None:
            flat[path] = a
        else:
            flat.setdefault(path, []).append(a)
    tree: Dict[Any, Any] = {}
    for path, a in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack(a) if isinstance(a, list) else a
    return rebuild_lists(tree)


def _linear(name: str, path: Tuple[Any, ...], layer: Optional[int] = None) -> List[Leaf]:
    return [(f"{name}.weight", path + ("w",), layer, "linear"),
            (f"{name}.bias", path + ("b",), layer, "same")]


def _norm(name: str, path: Tuple[Any, ...], layer: Optional[int] = None) -> List[Leaf]:
    return [(f"{name}.weight", path + ("scale",), layer, "same"),
            (f"{name}.bias", path + ("bias",), layer, "same")]


def _decoder_leaves(config: EtudeDecoderConfig) -> List[Leaf]:
    leaves = [("word_emb.weight", ("word_emb",), None, "same"),
              ("class_emb.weight", ("class_emb",), None, "same")]
    leaves += [(f"attr_emb.{name}.weight", ("attr_emb", name), None, "same")
               for name in ATTRIBUTE_ORDER]
    leaves += _linear("attr_proj", ("attr_proj",))
    for l in range(config.num_hidden_layers):
        for ln in ("ln1", "ln2"):
            leaves += _norm(f"layers.{l}.{ln}", ("layers", ln), l)
        for lin in ("qkv", "attn_out", "mlp_in", "mlp_out"):
            leaves += _linear(f"layers.{l}.{lin}", ("layers", lin), l)
    leaves += _norm("final_ln", ("final_ln",))
    leaves.append(("lm_head.weight", ("lm_head",), None, "linear"))
    return leaves


def decoder_state_from_jax(params: ParamTree,
                           config: EtudeDecoderConfig) -> Dict[str, torch.Tensor]:
    """The JAX tree as f32 CPU tensors under the decoder's PyTorch names."""
    return state_from_tree(params, _decoder_leaves(config))


def decoder_state_to_jax(state: Dict[str, torch.Tensor],
                         config: EtudeDecoderConfig) -> ParamTree:
    """Tensors under the decoder's PyTorch names (parameters, or anything
    shaped like them) → the JAX tree as numpy arrays; the inverse of
    `decoder_state_from_jax`."""
    return tree_from_state(state, _decoder_leaves(config))


@torch.no_grad()
def decoder_from_jax(params: ParamTree, config: EtudeDecoderConfig,
                     device="cpu") -> EtudeDecoder:
    """Build the port's decoder (f32 masters, eval mode) from the JAX tree.
    Leaves may be numpy arrays or anything `np.asarray` reads."""
    model = EtudeDecoder(config)
    model.load_state_dict(decoder_state_from_jax(params, config))
    return model.to(device).eval().requires_grad_(False)


def decoder_to_jax(model: EtudeDecoder) -> ParamTree:
    """The decoder's parameters as the JAX tree of numpy arrays: the exact
    inverse of `decoder_from_jax`."""
    return decoder_state_to_jax(dict(model.named_parameters()), model.config)


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


def _beat_leaves(config: BeatTransformerConfig) -> List[Leaf]:
    leaves: List[Leaf] = []
    for name in ("conv1", "conv2", "conv3"):
        leaves += [(f"{name}.weight", (name, "w"), None, "conv"),
                   (f"{name}.bias", (name, "b"), None, "same")]
    for i in range(config.nlayers):
        path = ("layers", i)
        for name in ("q", "k", "v", "ff1", "ff2"):
            leaves += _linear(f"layers.{i}.{name}", path + (name,))
        leaves += _norm(f"layers.{i}.ln1", path + ("ln1",))
        leaves += _norm(f"layers.{i}.ln2", path + ("ln2",))
        leaves.append((f"layers.{i}.er", path + ("er",), None, "same"))
        if i in config.instr_layers:
            for name in ("q", "k", "v", "o", "ff1", "ff2"):
                leaves += _linear(f"layers.{i}.instr.{name}", path + ("instr", name))
            leaves += _norm(f"layers.{i}.instr.ln1", path + ("instr", "ln1"))
            leaves += _norm(f"layers.{i}.instr.ln2", path + ("instr", "ln2"))
    return leaves + _linear("out", ("out",)) + _linear("out_tempo", ("out_tempo",))


@torch.no_grad()
def beat_transformer_from_jax(params: ParamTree, config: BeatTransformerConfig,
                              device="cpu") -> BeatTransformer:
    """Build the port's Beat-Transformer (f32 masters, eval mode) from the
    JAX tree."""
    model = BeatTransformer(config)
    model.load_state_dict(state_from_tree(params, _beat_leaves(config)))
    return model.to(device).eval().requires_grad_(False)


def beat_transformer_to_jax(model: BeatTransformer,
                            values: Optional[Dict[str, torch.Tensor]] = None) -> ParamTree:
    """The model's parameters (or `values` under its parameter names:
    gradients, Adam moments) as the JAX tree of numpy arrays: the exact
    inverse of `beat_transformer_from_jax`."""
    return tree_from_state(values or dict(model.named_parameters()),
                           _beat_leaves(model.config))


def _separator_leaves(config: SeparatorConfig) -> List[Leaf]:
    def conv(name, path, norm=True):
        leaves = [(f"{name}.conv.weight", path + ("w",), None, "conv"),
                  (f"{name}.conv.bias", path + ("b",), None, "same")]
        if norm:
            leaves += [(f"{name}.gn_scale", path + ("gn_scale",), None, "same"),
                       (f"{name}.gn_bias", path + ("gn_bias",), None, "same")]
        return leaves

    leaves: List[Leaf] = []
    for i in range(config.depth):
        leaves += conv(f"enc.{i}.down", ("enc", i, "down")) + conv(f"enc.{i}.ref", ("enc", i, "ref"))
    for i in range(config.depth):
        leaves += conv(f"dec.{i}.up", ("dec", i, "up")) + conv(f"dec.{i}.merge", ("dec", i, "merge"))
    return leaves + conv("mask_head", ("mask_head",), norm=False)


@torch.no_grad()
def separator_from_jax(params: ParamTree, config: SeparatorConfig,
                       device="cpu") -> Separator:
    """Build the port's separator U-Net (f32 masters, eval mode) from the
    JAX tree."""
    model = Separator(config)
    model.load_state_dict(state_from_tree(params, _separator_leaves(config)))
    return model.to(device).eval().requires_grad_(False)


def separator_to_jax(model: Separator,
                     values: Optional[Dict[str, torch.Tensor]] = None) -> ParamTree:
    """The model's parameters (or `values` under its parameter names) as the
    JAX tree: the exact inverse of `separator_from_jax`."""
    return tree_from_state(values or dict(model.named_parameters()),
                           _separator_leaves(model.config))


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


def _amt_leaves(config: AMTConfig) -> List[Leaf]:
    def attention(name, path, layer):
        return [leaf for n in "qkvo" for leaf in _linear(f"{name}.{n}", path + (n,), layer)]

    def feed_forward(name, path, layer):
        return (_linear(f"{name}.inp", path + ("in",), layer)
                + _linear(f"{name}.out", path + ("out",), layer))

    def norms(name, path, layer, n):
        return [leaf for i in range(n)
                for leaf in _norm(f"{name}.ln.{i}", path + (f"ln{i + 1}",), layer)]

    leaves: List[Leaf] = [("conv_w", ("conv", "w"), None, "same"),
                          ("conv_b", ("conv", "b"), None, "same")]
    leaves += _linear("tok_emb", ("tok_emb",))
    leaves += [(name, (name,), None, "same")
               for name in ("freq_pos_emb", "note_query", "time_pos_emb")]
    for stack, n in (("enc_layers", config.encoder_n_layer),
                     ("time_layers", config.decoder_n_layer)):
        for l in range(n):
            leaves += (attention(f"{stack}.{l}.attn", (stack, "attn"), l)
                       + feed_forward(f"{stack}.{l}.ff", (stack, "ff"), l)
                       + norms(f"{stack}.{l}", (stack,), l, 2))
    leaves += (attention("dec_zero.cross", ("dec_zero", "cross"), 0)
               + feed_forward("dec_zero.ff", ("dec_zero", "ff"), 0)
               + norms("dec_zero", ("dec_zero",), 0, 2))
    for l in range(config.decoder_n_layer - 1):
        leaves += (attention(f"dec_layers.{l}.self_attn", ("dec_layers", "self"), l)
                   + attention(f"dec_layers.{l}.cross", ("dec_layers", "cross"), l)
                   + feed_forward(f"dec_layers.{l}.ff", ("dec_layers", "ff"), l)
                   + norms(f"dec_layers.{l}", ("dec_layers",), l, 3))
    for heads in ("heads_freq", "heads_time"):
        for name in ("onset", "offset", "mpe", "velocity"):
            leaves += _linear(f"{heads}.{name}", (heads, name))
    return leaves


@torch.no_grad()
def amt_from_jax(params: ParamTree, config: AMTConfig, device="cpu") -> HFT:
    """Build the port's hFT transcriber (f32 masters, eval mode) from the
    JAX tree. `time_pos_emb` may be longer than `config.n_frame` (a
    checkpoint trained at 512-frame segments run at fewer frames)."""
    model = HFT(config, n_time_pos=len(params["time_pos_emb"]))
    model.load_state_dict(state_from_tree(params, _amt_leaves(config)))
    return model.to(device).eval().requires_grad_(False)


def amt_to_jax(model: HFT, values: Optional[Dict[str, torch.Tensor]] = None) -> ParamTree:
    """The model's parameters (or `values` under its parameter names) as the
    JAX tree: the exact inverse of `amt_from_jax`."""
    return tree_from_state(values or dict(model.named_parameters()),
                           _amt_leaves(model.config))
