"""The port's hFT transcriber (etude_tpu_torch/models/amt.py) and its weight
bridge (weights.py `init_amt_params_np`, `amt_from_jax`) against the JAX
package (etude_tpu/models/amt.py) on the same numpy inputs, in f32.

Tolerances: the initial parameters are the same numpy draws: equal. The
forwards are the same f32 arithmetic in another summation order through up
to 9 attention layers: the sigmoid heads to 1e-4 absolute (measured up to
7.6e-6 on the committed checkpoint), the velocity logits (|x| up to about
11) to 1e-3 absolute (measured up to 1.1e-4).
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etude_tpu.config.schema import ExtractorConfig as JaxExtractorConfig
from etude_tpu.data import extractor as jax_ext
from etude_tpu.models import amt as jamt
from etude_tpu.utils.training import load_params_only
from etude_tpu_torch.config import ExtractorConfig
from etude_tpu_torch.data.extractor import amt_config_from
from etude_tpu_torch.models.amt import AMTConfig
from etude_tpu_torch.weights import amt_from_jax, init_amt_params_np

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "checkpoints" / "extractor" / "latest.ckpt"
SIGMOID_ATOL = 1e-4
VELOCITY_ATOL = 1e-3
# tests/test_extractor.py's small extractor, and a variant with one decoder
# layer (no CAfreq layer after layer zero) and more heads.
TINY = dict(n_margin=4, n_frame=16, n_bin=32, cnn_kernel=3, hid_dim=32, pf_dim=64,
            encoder_n_layer=1, decoder_n_layer=2)
TINY_ONE_DEC = dict(n_margin=3, n_frame=10, n_bin=24, cnn_channel=2, cnn_kernel=4,
                    hid_dim=48, pf_dim=40, encoder_n_layer=2, encoder_n_head=6,
                    decoder_n_layer=1, decoder_n_head=3, n_note=12, n_velocity=16)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def committed_params():
    abstract = jax.eval_shape(lambda: jamt.init_params(jamt.AMTConfig(), seed=0))
    return _np_tree(load_params_only(CKPT, abstract))


@pytest.fixture
def jax_f32_extractor(monkeypatch):
    """The JAX extractor with its transcriber in f32 (its production call
    runs the bf16 default); the jit caches are cleared on both sides so no
    other test sees an f32 trace."""
    jitted = (jax_ext._transcribe_group, jax_ext._transcribe_groups,
              jax_ext._transcribe_batch)
    monkeypatch.setattr(jax_ext, "forward",
                        functools.partial(jamt.forward, compute_dtype=jnp.float32))
    for f in jitted:
        f.clear_cache()
    yield
    for f in jitted:
        f.clear_cache()


def _assert_heads_close(got, want):
    assert set(got) == set(want) and len(want) == 8
    for key, value in want.items():
        value = np.asarray(value)
        assert tuple(got[key].shape) == value.shape, key
        assert got[key].dtype == torch.float32, key
        atol = VELOCITY_ATOL if key.startswith("velocity") else SIGMOID_ATOL
        np.testing.assert_allclose(got[key].numpy(), value, atol=atol, rtol=0, err_msg=key)


@pytest.mark.parametrize("kw", [TINY, TINY_ONE_DEC, {}], ids=["tiny", "one_dec", "full"])
def test_init_params_equal_jax(kw):
    want = jax.tree_util.tree_flatten_with_path(_np_tree(jamt.init_params(jamt.AMTConfig(**kw), seed=3)))[0]
    got = jax.tree_util.tree_flatten_with_path(init_amt_params_np(AMTConfig(**kw), seed=3))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == np.float32, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("kw,B", [(TINY, 3), (TINY_ONE_DEC, 2)], ids=["tiny", "one_dec"])
def test_forward_matches_jax(kw, B):
    jc, tc = jamt.AMTConfig(**kw), AMTConfig(**kw)
    params = _np_tree(jamt.init_params(jc, seed=1))
    spec = np.random.default_rng(0).normal(size=(B, jc.n_bin, jc.n_frame + 2 * jc.n_margin)
                                           ).astype(np.float32)
    want = jamt.forward(params, jc, jnp.asarray(spec), compute_dtype=jnp.float32)
    got = amt_from_jax(params, tc)(torch.from_numpy(spec), torch.float32)
    _assert_heads_close(got, want)


@pytest.mark.parametrize("n_frame", [32, 64])
def test_committed_checkpoint_at_few_frames_matches_jax(committed_params, n_frame):
    """The committed 512-frame checkpoint run at fewer frames: the time
    position embedding keeps its 512 rows and the forward reads the first
    n_frame. Input at log-mel levels (the min_value fill is -18)."""
    jc, tc = jamt.AMTConfig(n_frame=n_frame), AMTConfig(n_frame=n_frame)
    spec = np.random.default_rng(n_frame).normal(-6.0, 3.0, size=(2, 256, n_frame + 64)
                                                 ).astype(np.float32)
    want = jamt.forward(committed_params, jc, jnp.asarray(spec), compute_dtype=jnp.float32)
    model = amt_from_jax(committed_params, tc)
    assert model.time_pos_emb.shape == (512, 256)
    with torch.inference_mode():
        got = model(torch.from_numpy(spec), torch.float32)
    _assert_heads_close(got, want)


def test_folded_front_end_is_the_window_conv_then_the_embedding():
    """The fold against the reference's unfolded chain (window conv, flatten,
    token embedding; amt_apc.py:65-110) on the port alone."""
    c = AMTConfig(**TINY)
    model = amt_from_jax(init_amt_params_np(c, seed=2), c)
    x = torch.randn(5, c.n_proc, dtype=torch.float64)
    conv = torch.stack([
        sum(model.conv_w[ch, t].double() * x[:, t:t + c.conv_out] for t in range(c.cnn_kernel))
        + model.conv_b[ch].double() for ch in range(c.cnn_channel)], dim=1)  # [5, C, n_out]
    want = conv.reshape(5, -1) @ model.tok_emb.weight.double().T + model.tok_emb.bias.double()
    wf, bias = model.folded_frontend()
    torch.testing.assert_close((x.float() @ wf + bias).double(), want, atol=1e-6, rtol=1e-5)


def test_amt_config_from_settings_matches_jax():
    cfg, jcfg = ExtractorConfig(), JaxExtractorConfig()
    for c in (cfg, jcfg):
        c.input.num_frame, c.model.decoder_n_layer, c.feature.n_bins = 128, 2, 64
    got = amt_config_from(cfg)
    assert got == AMTConfig(**vars(jax_ext.amt_config_from(jcfg)))
    assert amt_config_from(cfg, n_frame=16).n_frame == 16
    cfg.input.margin_f = 16
    with pytest.raises(ValueError, match="asymmetric margins"):
        amt_config_from(cfg)
