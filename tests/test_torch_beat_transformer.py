"""The port's Beat-Transformer (etude_tpu_torch/models/beat_transformer.py),
its weight bridge and its BeatDetector against the JAX package, on the same
numpy inputs, in f32.

Tolerances: the forwards do the same f32 arithmetic in another summation
order: 1e-5 relative to the largest logit (the precedent of
tests/test_beat.py). The detector's beat lists must be identical. (Its
activations on the committed checkpoint are held to the JAX package's in
tests/test_torch_structuralize.py.)
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import etude_tpu.data.beat_detector as jax_bd
from etude_tpu.config.schema import BeatDetectorConfig as JaxBeatDetectorConfig
from etude_tpu.models import beat_transformer as jbt
from etude_tpu.utils.training import load_params_only
from etude_tpu_torch.config import BeatDetectorConfig
from etude_tpu_torch.data.beat_detector import BeatDetector
from etude_tpu_torch.models.beat_transformer import BeatTransformerConfig
from etude_tpu_torch.ops.dilated_attention import dilated_attention
from etude_tpu_torch.tools.reference_state import beat_state_dict
from etude_tpu_torch.weights import beat_transformer_from_jax, init_beat_params_np

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "checkpoints" / "beat_detector" / "latest.ckpt"
TINY = dict(dmodel=32, nhead=8, d_hid=64, nlayers=3)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def committed_params():
    abstract = jax.eval_shape(lambda: jbt.init_params(jbt.BeatTransformerConfig(), seed=0))
    return _np_tree(load_params_only(CKPT, abstract))


@pytest.fixture
def jax_f32_detector(monkeypatch):
    """The JAX BeatDetector with its forward in f32 (its production call
    runs the bf16 default); the jit cache is cleared on both sides so no
    other test sees an f32 trace."""
    monkeypatch.setattr(jax_bd, "forward",
                        functools.partial(jbt.forward, compute_dtype=jnp.float32))
    jax_bd._beat_activations_jit.clear_cache()
    yield
    jax_bd._beat_activations_jit.clear_cache()


def _features(T, seed):
    rng = np.random.default_rng(seed)
    return np.clip(-40.0 + 15.0 * rng.normal(size=(5, T, 128)), -80.0, 0.0).astype(np.float32)


def _both(params, kw, x):
    jax_act, jax_tempo = jbt.forward(params, jbt.BeatTransformerConfig(**kw),
                                     jnp.asarray(x), compute_dtype=jnp.float32)
    model = beat_transformer_from_jax(_np_tree(params), BeatTransformerConfig(**kw))
    with torch.no_grad():
        act, tempo = model(torch.tensor(x), torch.float32)
    return (np.asarray(jax_act), np.asarray(jax_tempo)), (act.numpy(), tempo.numpy())


def _close(out, ref):
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("kw", [TINY, {}], ids=["tiny", "published"])
def test_init_params_bit_exact(kw):
    jp = jbt.init_params(jbt.BeatTransformerConfig(**kw), seed=3)
    npp = init_beat_params_np(BeatTransformerConfig(**kw), seed=3)
    assert jax.tree.structure(_np_tree(jp)) == jax.tree.structure(npp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(npp)):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("head7_bug", [False, True])
def test_tiny_forward_matches_jax(head7_bug):
    kw = dict(TINY, compat_head7_bug=head7_bug)
    params = jbt.init_params(jbt.BeatTransformerConfig(**kw), seed=1, std=0.2)
    x = _features(96, seed=2)[None]
    (ja, jt), (pa, pt) = _both(params, kw, x)
    assert pa.shape == (1, 96, 2) and pt.shape == (1, 300)
    _close(pa, ja)
    _close(pt, jt)


def test_committed_checkpoint_forward_matches_jax(committed_params):
    """Full width (dmodel 256, 8 heads, 9 layers) at T = 64 frames: every
    dilation up to 256 reaches past both ends; both heads."""
    x = _features(64, seed=3)[None]
    (ja, jt), (pa, pt) = _both(committed_params, {}, x)
    _close(pa, ja)
    _close(pt, jt)


def test_forward_launches_nine_attention_layers(committed_params):
    model = beat_transformer_from_jax(committed_params, BeatTransformerConfig())
    calls = []
    import etude_tpu_torch.models.beat_transformer as bt

    def spy(*args, **kw):
        calls.append(args[4])
        return dilated_attention(*args, **kw)

    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(bt, "dilated_attention", spy)
        model(torch.tensor(_features(32, seed=4)[None]), torch.float32)
    assert calls == [2 ** i for i in range(9)]


def _tiny_detector_config():
    config = BeatDetectorConfig()
    for key, value in TINY.items():
        setattr(config.model, key, value)
    return config


def test_detect_writes_json_and_cleans_up(tmp_path):
    """Mirror of tests/test_structuralize.py::test_beat_detector_pipeline on
    the port's inputs: features in memory (an array or a tensor, never a
    .npy file, so there is nothing to clean up) give the same results, and
    the caller's features are left as they were."""
    params = init_beat_params_np(BeatTransformerConfig(**TINY), seed=0)
    detector = BeatDetector(_tiny_detector_config(), params=params, device="cpu")
    feats = np.random.default_rng(0).normal(size=(5, 400, 128)).astype(np.float32)
    kept = feats.copy()
    out_json = tmp_path / "beat_pred.json"
    results = detector.detect(feats, out_json)
    assert set(results) == {"beat_pred", "downbeat_pred"}
    assert json.loads(out_json.read_text()) == results
    assert detector.detect(torch.from_numpy(feats)) == results
    np.testing.assert_array_equal(feats, kept)


@pytest.mark.parametrize("octave", [False, True])
def test_detect_matches_jax(octave, jax_f32_detector):
    """Same weights and features: identical beat and downbeat lists, with
    and without the octave pass."""
    kw = dict(TINY)
    params = jbt.init_params(jbt.BeatTransformerConfig(**kw), seed=2, std=0.3)
    jconfig = JaxBeatDetectorConfig(octave_disambiguation=octave)
    for key, value in kw.items():
        setattr(jconfig.model, key, value)
    config = _tiny_detector_config()
    config.octave_disambiguation = octave
    feats = _features(400, seed=6)
    ref = jax_bd.BeatDetector(jconfig, params=params).detect(feats)
    out = BeatDetector(config, params=_np_tree(params), device="cpu").detect(feats)
    assert out == ref


def test_weights_follow_the_loader_rules(tmp_path):
    with pytest.raises(RuntimeError, match="orbax"):
        BeatDetector(BeatDetectorConfig(), model_path=CKPT, device="cpu")
    # A reference .pth is converted and runs with head 7's keys from head 6.
    tree = init_beat_params_np(BeatTransformerConfig(**TINY), seed=4)
    pth = tmp_path / "beat.pth"
    torch.save({"state_dict": beat_state_dict(tree, BeatTransformerConfig(**TINY))}, pth)
    ref = BeatDetector(_tiny_detector_config(), model_path=pth, device="cpu")
    assert ref.model_config.compat_head7_bug and ref.model.config.compat_head7_bug
    for a, b in zip(ref.model.state_dict().values(),
                    beat_transformer_from_jax(tree, BeatTransformerConfig(**TINY)).state_dict().values()):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    missing = tmp_path / "none.ckpt"
    with pytest.raises(FileNotFoundError):
        BeatDetector(_tiny_detector_config(), model_path=missing, device="cpu")
    det = BeatDetector(_tiny_detector_config(), model_path=missing, device="cpu",
                       allow_random_weights=True)
    expect = beat_transformer_from_jax(
        init_beat_params_np(BeatTransformerConfig(**TINY), seed=0),
        BeatTransformerConfig(**TINY))
    for a, b in zip(det.model.state_dict().values(), expect.state_dict().values()):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
