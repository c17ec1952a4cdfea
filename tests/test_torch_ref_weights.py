"""Reference PyTorch checkpoints in the port (etude_tpu_torch/utils/
torch_port.py and the loaders of utils/model_loader.py, data/extractor.py,
data/beat_detector.py) against the JAX package's (etude_tpu/utils/
torch_port.py and its loaders).

No reference weights are in the repository: synthetic state dicts at small
widths are drawn from a seed under the reference's parameter names
(`tools/reference_state.py`, the inverse of the converters; every tensor
redrawn, so no two leaves are alike).
- Both packages' converters must give identical trees (the same numpy
  copies and transposes).
- The files, written as a user holds them (`.pth` state dicts; the hFT
  also as a whole-model `.pkl` in three pickle formats), through both
  packages' loaders, must give forwards that agree in f32: the decoder's
  logits within 1e-5 (tests/test_torch_decoder.py), the hFT's heads within
  1e-4 (sigmoids; 1e-3 for velocity probabilities, tests/test_torch_amt.py),
  the beat model's logits within 1e-5 of their largest (tests/
  test_torch_beat_transformer.py), the last with head 7's keys taken from
  head 6, as the reference trained.
- Where `transformers` is importable, the port's decoder on a converted
  GPT-NeoX state dict gives the reference composition's logits, as
  tests/test_torch_port.py holds for the JAX package (rtol = atol = 2e-4).
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etude_tpu.config.schema import BeatDetectorConfig as JaxBeatDetectorConfig
from etude_tpu.config.schema import ExtractorConfig as JaxExtractorConfig
from etude_tpu.data import beat_detector as jax_bd
from etude_tpu.data import extractor as jax_ext
from etude_tpu.models import amt as jamt
from etude_tpu.models import beat_transformer as jbt
from etude_tpu.models import decoder as jdec
from etude_tpu.utils import model_loader as jax_loader
from etude_tpu.utils import torch_port as jtp
from etude_tpu_torch.config import BeatDetectorConfig, ExtractorConfig
from etude_tpu_torch.data.beat_detector import BeatDetector
from etude_tpu_torch.data.extractor import AMTAPC_Extractor, amt_config_from
from etude_tpu_torch.models.amt import AMTConfig
from etude_tpu_torch.models.beat_transformer import BeatTransformerConfig
from etude_tpu_torch.models.decoder import ATTRIBUTE_ORDER, EtudeDecoderConfig
from etude_tpu_torch.tools import reference_state as rs
from etude_tpu_torch.utils import torch_port as tp
from etude_tpu_torch.utils.model_loader import load_etude_decoder
from etude_tpu_torch.weights import (init_amt_params_np, init_beat_params_np,
                                     init_decoder_params_np)
from test_torch_amt import _assert_heads_close
from test_torch_extract import _small

DECODER = dict(vocab_size=50, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=128, max_position_embeddings=64, attribute_emb_dim=8)
AMT = dict(n_margin=4, n_frame=16, n_bin=32, cnn_kernel=3, hid_dim=32, pf_dim=64,
           encoder_n_layer=1, decoder_n_layer=2)
BEAT = dict(dmodel=32, nhead=8, d_hid=64, nlayers=6)


def _redrawn(state_dict, seed, std=0.1):
    """The same names and shapes, every tensor drawn anew from a seed."""
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.normal(0.0, std, tuple(v.shape)).astype(np.float32))
            for k, v in state_dict.items()}


def _decoder_sd(seed=0):
    cfg = EtudeDecoderConfig(**DECODER)
    return _redrawn(rs.decoder_state_dict(init_decoder_params_np(cfg), cfg), seed)


def _amt_sd(seed=1):
    cfg = AMTConfig(**AMT)
    return _redrawn(rs.amt_state_dict(init_amt_params_np(cfg), cfg), seed)


def _beat_sd(seed=2):
    cfg = BeatTransformerConfig(**BEAT)
    return _redrawn(rs.beat_state_dict(init_beat_params_np(cfg), cfg), seed)


def _assert_trees_equal(ours, ref):
    ref = jax.tree.map(np.asarray, ref)
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", ["decoder", "amt", "beat"])
def test_converters_give_the_jax_trees(which):
    if which == "decoder":
        sd = _decoder_sd()
        # torch.compile prefixes and a backbone key the decoder does not read.
        sd = {f"_orig_mod.{k}": v for k, v in sd.items()} | {
            "transformer.embed_in.weight": torch.zeros(3)}
        ours = tp.convert_etude_decoder_state_dict(sd, EtudeDecoderConfig(**DECODER))
        ref = jtp.convert_etude_decoder_state_dict(sd, jdec.EtudeDecoderConfig(**DECODER))
    elif which == "amt":
        sd = _amt_sd()
        ours = tp.convert_amt_state_dict(sd, AMTConfig(**AMT))
        ref = jtp.convert_amt_state_dict(sd, jamt.AMTConfig(**AMT))
    else:
        sd = _beat_sd()
        ours = tp.convert_beat_state_dict(sd, BeatTransformerConfig(**BEAT))
        ref = jtp.convert_beat_state_dict(sd, jbt.BeatTransformerConfig(**BEAT))
    _assert_trees_equal(ours, ref)


def test_reference_state_is_the_converters_inverse():
    cfg = EtudeDecoderConfig(**DECODER)
    tree = tp.convert_etude_decoder_state_dict(_decoder_sd(), cfg)
    _assert_trees_equal(tp.convert_etude_decoder_state_dict(rs.decoder_state_dict(tree, cfg), cfg),
                        tree)
    beat_cfg = BeatTransformerConfig(**BEAT)
    tree = tp.convert_beat_state_dict(_beat_sd(), beat_cfg)
    _assert_trees_equal(tp.convert_beat_state_dict(rs.beat_state_dict(tree, beat_cfg), beat_cfg),
                        tree)


def test_decoder_pth_through_both_loaders(tmp_path):
    """A `.pth` holding {"model_state_dict": ...}, through
    `load_etude_decoder` of both packages: f32 logits within 1e-5."""
    config_path = tmp_path / "etude_decoder_config.json"
    EtudeDecoderConfig(**DECODER).to_json_file(config_path)
    pth = tmp_path / "decoder.pth"
    torch.save({"model_state_dict": _decoder_sd(), "epoch": 3}, pth)
    model, config = load_etude_decoder(config_path, pth, device="cpu")
    params, jconfig = jax_loader.load_etude_decoder(config_path, pth)
    rng = np.random.default_rng(3)
    ids = rng.integers(4, DECODER["vocab_size"], (2, 17))
    cls = rng.integers(1, 3, (2, 17))
    attrs = {n: rng.integers(0, 3, (2, 17)) for n in ATTRIBUTE_ORDER}
    ref = jdec.forward(params, jconfig, jnp.asarray(ids, jnp.int32), jnp.asarray(cls, jnp.int32),
                       {k: jnp.asarray(v, jnp.int32) for k, v in attrs.items()},
                       compute_dtype=jnp.float32)
    with torch.no_grad():
        out = model(torch.tensor(ids), torch.tensor(cls),
                    {k: torch.tensor(v) for k, v in attrs.items()}, compute_dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("suffix,fmt", [(".pth", None), (".pt", None), (".pkl", "pickle"),
                                        (".pkl", "zip"), (".pkl", "legacy")])
def test_hft_reference_files_through_both_extractors(tmp_path, suffix, fmt):
    """The hFT as a state dict or a whole-model pickle, through both
    packages' `AMTAPC_Extractor`: equal trees, f32 heads within 1e-4."""
    settings = _small(ExtractorConfig)
    assert dataclasses.asdict(amt_config_from(settings)) == dataclasses.asdict(AMTConfig(**AMT))
    sd = _amt_sd()
    path = tmp_path / f"hft{suffix}"
    if fmt is None:
        torch.save(sd, path)
    else:
        rs.save_whole_model(sd, path, fmt)
        assert rs._PICKLE_MODULE not in sys.modules
    ours = AMTAPC_Extractor(settings, model_path=path, device="cpu")
    ref = jax_ext.AMTAPC_Extractor(_small(JaxExtractorConfig), model_path=path)
    tree = tp.convert_amt_state_dict(sd, AMTConfig(**AMT))
    for name, value in ours.model.state_dict().items():
        assert torch.isfinite(value).all(), name
    spec = np.random.default_rng(4).normal(
        size=(2, AMT["n_bin"], AMT["n_frame"] + 2 * AMT["n_margin"])).astype(np.float32)
    want = jamt.forward(ref.params, jamt.AMTConfig(**AMT), jnp.asarray(spec),
                        compute_dtype=jnp.float32)
    with torch.no_grad():
        got = ours.model(torch.from_numpy(spec), torch.float32)
    _assert_heads_close(got, want)
    _assert_trees_equal(tree, jax.tree.map(np.asarray, ref.params))


def test_beat_pth_runs_with_head7_compat_in_both_detectors(tmp_path):
    """A Beat-Transformer `.pth` holding {"state_dict": ...}: both detectors
    turn on the head-7 compat; f32 logits within 1e-5 of their largest, and
    the same weights without the compat differ by ten times that. The
    weights are the seeded init with the dilated layers' query and key
    weights x8: at init scale each head's softmax over its 5 keys is nearly
    flat, and whose keys head 7 reads hardly shows."""
    cfg = BeatTransformerConfig(**BEAT)
    tree = init_beat_params_np(cfg, seed=2)
    for layer in tree["layers"]:
        layer["q"]["w"] *= 8.0
        layer["k"]["w"] *= 8.0
    pth = tmp_path / "beat.pth"
    torch.save({"state_dict": rs.beat_state_dict(tree, cfg)}, pth)
    config, jconfig = BeatDetectorConfig(), JaxBeatDetectorConfig()
    for key, value in BEAT.items():
        setattr(config.model, key, value)
        setattr(jconfig.model, key, value)
    ours = BeatDetector(config, model_path=pth, device="cpu")
    ref = jax_bd.BeatDetector(jconfig, model_path=pth)
    assert ours.model_config.compat_head7_bug and ref.model_config.compat_head7_bug
    assert ours.model.config.compat_head7_bug
    x = np.clip(-40.0 + 15.0 * np.random.default_rng(5).normal(size=(1, 5, 64, 128)),
                -80.0, 0.0).astype(np.float32)
    want, _ = jbt.forward(ref.params, ref.model_config, jnp.asarray(x),
                          compute_dtype=jnp.float32)
    want = np.asarray(want)
    with torch.no_grad():
        got, _ = ours.model(torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    plain, _ = jbt.forward(ref.params, dataclasses.replace(ref.model_config,
                                                           compat_head7_bug=False),
                           jnp.asarray(x), compute_dtype=jnp.float32)
    assert np.abs(np.asarray(plain) - want).max() > 1e-4 * np.abs(want).max()


@pytest.fixture(scope="module")
def gpt_neox_reference():
    """The reference decoder composition (word + class + projected attribute
    embeddings → GPTNeoXModel → untied lm_head) with seeded torch weights,
    as tests/test_torch_port.py builds it."""
    transformers = pytest.importorskip("transformers")
    cfg = EtudeDecoderConfig(**DECODER)
    torch.manual_seed(0)
    word = torch.nn.Embedding(cfg.vocab_size, cfg.hidden_size)
    cls = torch.nn.Embedding(cfg.num_classes, cfg.hidden_size)
    attr_embs = {name: torch.nn.Embedding(cfg.num_attribute_bins, cfg.attribute_emb_dim)
                 for name in ATTRIBUTE_ORDER}
    proj = torch.nn.Linear(4 * cfg.attribute_emb_dim, cfg.hidden_size)
    backbone = transformers.GPTNeoXModel(transformers.GPTNeoXConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_hidden_layers, num_attention_heads=cfg.num_attention_heads,
        intermediate_size=cfg.intermediate_size,
        max_position_embeddings=cfg.max_position_embeddings,
        attention_dropout=0.0, hidden_dropout=0.0)).eval()
    head = torch.nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)
    modules = {"word_embeddings": word, "class_embeddings": cls,
               **{tp.ATTR_MODULE[n]: attr_embs[n] for n in ATTRIBUTE_ORDER},
               "attribute_projection": proj, "transformer": backbone, "lm_head": head}
    state_dict = {f"{prefix}.{k}": v for prefix, m in modules.items()
                  for k, v in m.state_dict().items()}

    def forward(ids, class_ids, attrs):
        with torch.no_grad():
            embeds = word(ids) + cls(class_ids) + proj(torch.cat(
                [attr_embs[n](attrs[n]) for n in ATTRIBUTE_ORDER], dim=-1))
            return head(backbone(inputs_embeds=embeds).last_hidden_state).numpy()

    return cfg, state_dict, forward


def test_gpt_neox_logits_through_the_port(gpt_neox_reference, tmp_path):
    cfg, state_dict, forward = gpt_neox_reference
    config_path = tmp_path / "etude_decoder_config.json"
    cfg.to_json_file(config_path)
    pth = tmp_path / "decoder.pth"
    torch.save(state_dict, pth)
    model, _ = load_etude_decoder(config_path, pth, device="cpu")
    rng = np.random.default_rng(1)
    ids = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 17)))
    class_ids = torch.tensor(rng.integers(0, 3, (2, 17)))
    attrs = {n: torch.tensor(rng.integers(0, 3, (2, 17))) for n in ATTRIBUTE_ORDER}
    with torch.no_grad():
        ours = model(ids, class_ids, attrs, compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(ours, forward(ids, class_ids, attrs), rtol=2e-4, atol=2e-4)
