"""The port's separation path (etude_tpu_torch/models/separator.py,
ops/mel.py, data/separation.py, utils/audio.py, the weight bridge) against
the JAX package on the same numpy inputs, in f32, and mirrors of
tests/test_structuralize.py's separator tests.

Tolerances: the filterbank, the DFT bases and the wave padding are the same
numpy code: equal. The U-Net's masks lie in [0, 1] and are the same f32
arithmetic in another summation order through up to 21 convs and
GroupNorms: 1e-5 relative with an absolute floor of 1e-4 (measured up to
2e-5 at full width). Features are dB, in [-80, 0]: 1e-2 dB (measured up to
3.4e-3 dB at full width, in the quietest bins, where dB magnifies the
rounding).
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import etude_tpu.data.separation as jax_sep
from etude_tpu.models import separator as jsep
from etude_tpu.ops import mel as jax_mel
from etude_tpu.utils import audio as jax_audio
from etude_tpu.utils.training import load_params_only
from etude_tpu_torch.data import separation as sep
from etude_tpu_torch.models.separator import SeparatorConfig
from etude_tpu_torch.ops import mel
from etude_tpu_torch.utils import audio
from etude_tpu_torch.weights import init_separator_params_np, separator_from_jax

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "checkpoints" / "separator" / "latest.ckpt"
TINY = dict(base_channels=2, depth=2)
MASK_TOL = dict(rtol=1e-5, atol=1e-4)
DB_ATOL = 1e-2


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def committed_params():
    abstract = jax.eval_shape(lambda: jsep.init_params(jsep.SeparatorConfig(), seed=0))
    return _np_tree(load_params_only(CKPT, abstract))


@pytest.fixture
def jax_f32_separator(monkeypatch):
    """The JAX SourceSeparator with its U-Net in f32 (its production call
    runs the bf16 default); the jit cache is cleared on both sides so no
    other test sees an f32 trace."""
    monkeypatch.setattr(jax_sep, "forward",
                        functools.partial(jsep.forward, compute_dtype=jnp.float32))
    jax_sep._separate_mel_jit.clear_cache()
    yield
    jax_sep._separate_mel_jit.clear_cache()


def _tone_wav(path, seconds=1.0, sr=44100, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    wave = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.1 * np.sin(2 * np.pi * 1320 * t)
            + 0.02 * rng.normal(size=t.size)).astype(np.float32)
    audio.save_wav(path, wave, sr)
    return wave


@pytest.mark.parametrize("kw", [
    dict(sr=44100, n_fft=4096, n_mels=128, fmin=30.0, fmax=11000.0, mel_scale="slaney"),
    dict(sr=16000, n_fft=2048, n_mels=256),
])
def test_mel_filterbank_equals_jax(kw):
    np.testing.assert_array_equal(mel.mel_filterbank(**kw), jax_mel.mel_filterbank(**kw))


def test_dft_bases_and_padding_equal_jax():
    cos_m, sin_m = mel.dft_matrices(512, torch.device("cpu"))
    jcos, jsin = jax_mel.dft_matrices(512)
    np.testing.assert_array_equal(cos_m.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(sin_m.numpy(), np.asarray(jsin))
    for n in (100, 3000, 50000):
        wave = np.random.default_rng(n).normal(size=n).astype(np.float32)
        np.testing.assert_array_equal(mel.reflect_pad_host(wave, 2048),
                                      jax_mel.reflect_pad_host(wave, 2048))
        padded, true_frames = sep.pad_bucket_wave(wave)
        jpadded, jtrue = jax_sep.pad_bucket_wave(wave)
        assert true_frames == jtrue
        np.testing.assert_array_equal(padded, jpadded)


@pytest.mark.parametrize("kw", [TINY, {}], ids=["tiny", "published"])
def test_init_params_bit_exact(kw):
    jp = jsep.init_params(jsep.SeparatorConfig(**kw), seed=1)
    npp = init_separator_params_np(SeparatorConfig(**kw), seed=1)
    assert jax.tree.structure(_np_tree(jp)) == jax.tree.structure(npp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(npp)):
        np.testing.assert_array_equal(np.asarray(a), b)


def _forward_both(params, kw, mag):
    ref = jsep.forward(params, jsep.SeparatorConfig(**kw), jnp.asarray(mag),
                       compute_dtype=jnp.float32)
    model = separator_from_jax(_np_tree(params), SeparatorConfig(**kw))
    with torch.no_grad():
        out = model(torch.tensor(mag), torch.float32)
    return np.asarray(ref), out.numpy()


@pytest.mark.parametrize("kw,shape", [
    (dict(base_channels=4, depth=2), (1, 40, 65)),     # tests/test_structuralize.py
    (dict(base_channels=6, depth=3, freq_bins=40), (2, 37, 70)),  # band < F, padding
])
def test_tiny_forward_matches_jax(kw, shape):
    params = jsep.init_params(jsep.SeparatorConfig(**kw), seed=0, std=0.3)
    mag = np.random.default_rng(0).uniform(size=shape).astype(np.float32)
    ref, out = _forward_both(params, kw, mag)
    assert out.shape == (shape[0], 5, shape[1], shape[2])
    np.testing.assert_allclose(out, ref, **MASK_TOL)
    np.testing.assert_allclose(out.sum(axis=1), 1.0, atol=1e-5)
    assert (out >= 0).all()


def test_committed_checkpoint_forward_matches_jax(committed_params):
    """Full width (base 24, depth 5, band 1024) at T = 40 frames of a
    2049-bin spectrogram: rows above the band are uniform."""
    mag = np.log1p(np.random.default_rng(1).gamma(0.5, 2.0, size=(1, 40, 2049))
                   ).astype(np.float32)
    ref, out = _forward_both(committed_params, {}, mag)
    np.testing.assert_allclose(out, ref, **MASK_TOL)
    np.testing.assert_array_equal(out[..., 1024:], np.float32(0.2))
    np.testing.assert_array_equal(out[..., 1024:], ref[..., 1024:])


def test_power_to_db_matches_librosa_semantics():
    """Mirror of tests/test_structuralize.py, and equal to the JAX version."""
    S = np.array([[1.0, 0.1], [0.01, 1e-12]])
    db = sep.power_to_db(S)
    np.testing.assert_array_equal(db, jax_sep.power_to_db(S))
    assert db.max() == pytest.approx(0.0)
    assert db[0, 1] == pytest.approx(-10.0)
    assert db.min() >= -80.0


def test_device_power_to_db_matches_jax():
    rng = np.random.default_rng(2)
    power = (rng.gamma(0.3, 1.0, size=(5, 60, 16)) ** 4).astype(np.float32)
    power[:, 50:] *= 1e6                       # padded frames must not set the max
    ref = jax_sep._power_to_db_jit(jnp.asarray(power), jnp.arange(60) < 50)
    out = sep.power_to_db_device(torch.tensor(power), 50)
    np.testing.assert_allclose(out.numpy()[:, :50], np.asarray(ref)[:, :50],
                               atol=1e-4, rtol=0)


def test_mask_input_is_rms_normalized():
    """Mirror of tests/test_structuralize.py: scaling the wave by a power of
    two leaves the net's input unchanged, so the mel power scales by gain²."""
    rng = np.random.default_rng(1)
    t = np.arange(44100) / 44100
    wave = (0.2 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.normal(size=len(t))
            ).astype(np.float32)
    n_frames = 1 + (len(wave) - sep.SEP_N_FFT) // sep.SEP_HOP
    cfg = SeparatorConfig(base_channels=2, depth=2)
    model = separator_from_jax(init_separator_params_np(cfg, seed=0), cfg)
    with torch.no_grad():
        a, b = (sep.separate_mel(model, torch.tensor(g * wave), n_frames, torch.float32)
                .double().numpy() for g in (1.0, 0.25))
    np.testing.assert_allclose(a, b * 16.0, rtol=1e-4, atol=1e-12)


def test_source_separator_features_match_jax(tmp_path, jax_f32_separator,
                                             committed_params):
    """A 1 s WAV through both SourceSeparators with the committed checkpoint:
    int16 transfer, STFT, masks, mel, dB. (A tiny random-weight U-Net is no
    good here: 44 true frames in a 2048-frame bucket leave its GroupNorm
    variances near 1e-6, under the 1e-5 epsilon, and f32 summation order then
    moves its masks by percents on either side.)"""
    path = tmp_path / "mix.wav"
    _tone_wav(path)
    ref = jax_sep.SourceSeparator(params=committed_params).separate_features(path)
    out = sep.SourceSeparator(params=committed_params, device="cpu"
                              ).separate_features(path)
    assert out.shape == ref.shape == (5, 1 + 44100 // 1024, 128)
    np.testing.assert_allclose(out, ref, atol=DB_ATOL, rtol=0)


def test_source_separator_features_contract(tmp_path):
    """Mirror of tests/test_structuralize.py::test_source_separator_features_contract."""
    path = tmp_path / "mix.wav"
    _tone_wav(path)
    cfg = SeparatorConfig(**TINY)
    separator = sep.SourceSeparator(params=init_separator_params_np(cfg, seed=0),
                                    config=cfg, device="cpu")
    features = separator.separate_features(path)
    assert features.shape == (5, 1 + 44100 // 1024, 128)
    assert features.max() == pytest.approx(0.0, abs=1e-4)
    assert features.min() >= -80.0
    on_device = separator.separate_features(path, return_device=True)
    assert isinstance(on_device, torch.Tensor)
    np.testing.assert_array_equal(on_device.numpy(), features)
    # A file at another rate is resampled to 44.1 kHz first.
    low = tmp_path / "mix_22k.wav"
    _tone_wav(low, sr=22050)
    resampled = separator.separate_features(low)
    assert resampled.shape == (5, 1 + 44100 // 1024, 128)


def test_separator_weights_follow_the_loader_rules(tmp_path):
    with pytest.raises(RuntimeError, match="orbax"):
        sep.SourceSeparator(model_path=CKPT, device="cpu")
    with pytest.raises(FileNotFoundError):
        sep.SourceSeparator(model_path=tmp_path / "none.ckpt", device="cpu")


def test_wav_io_and_resampling_match_jax(tmp_path):
    path = tmp_path / "x.wav"
    wave = _tone_wav(path, seconds=0.5, seed=3)
    ours, sr = audio.load_wav(path)
    ref, jsr = jax_audio.load_wav(path)
    assert sr == jsr == 44100
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_allclose(ours, wave, atol=2.0 / 32768)   # int16 PCM
    # scipy's filter in f32 (the JAX package may take its native FIR with the
    # same taps): equal to f32 rounding of values in [-1, 1].
    np.testing.assert_allclose(audio.resample_audio(ours, 44100, 16000),
                               jax_audio.resample_audio(ours, 44100, 16000),
                               atol=1e-5, rtol=0)
    decoded, _ = audio.decode_audio(path, target_sr=22050)
    np.testing.assert_array_equal(decoded, audio.resample_audio(ours, 44100, 22050))


@pytest.mark.parametrize("sr", [44100, 22050], ids=["int16", "resampled"])
def test_bypass_features_match_jax(tmp_path, sr):
    """The separator bypass (no mask net, no weights: the mix's mel power in
    every stem slot) against the JAX package's on a 1 s WAV, within the
    feature tolerance DB_ATOL; every stem is the same."""
    path = tmp_path / "mix.wav"
    _tone_wav(path, sr=sr)
    ref = jax_sep.SourceSeparator(bypass=True).separate_features(path)
    separator = sep.SourceSeparator(bypass=True, device="cpu")
    assert separator.model is None
    out = separator.separate_features(path)
    assert out.shape == ref.shape == (5, 1 + 44100 // 1024, 128)
    np.testing.assert_allclose(out, ref, atol=DB_ATOL, rtol=0)
    np.testing.assert_array_equal(out, np.broadcast_to(out[:1], out.shape))
    assert out.max() == pytest.approx(0.0, abs=1e-4) and out.min() >= -80.0


def test_npy_features_round_trip_through_the_beat_detector(tmp_path):
    """`separate_features(output_npy_path=...)` saves what it returns, and
    `BeatDetector.detect` on that path gives the beats of the array and
    deletes the file, unless told to keep it (JAX :236-241,
    beat_detector.py:122-190)."""
    from etude_tpu_torch.config import BeatDetectorConfig
    from etude_tpu_torch.data.beat_detector import BeatDetector
    from etude_tpu_torch.models.beat_transformer import BeatTransformerConfig
    from etude_tpu_torch.weights import init_beat_params_np

    wav = tmp_path / "mix.wav"
    _tone_wav(wav, seconds=3.0)
    npy = tmp_path / "feats" / "mix.npy"
    features = sep.SourceSeparator(bypass=True, device="cpu").separate_features(
        wav, output_npy_path=npy)
    np.testing.assert_array_equal(np.load(npy), features)
    config = BeatDetectorConfig()
    config.model.dmodel, config.model.d_hid, config.model.nlayers = 32, 64, 3
    params = init_beat_params_np(BeatTransformerConfig(dmodel=32, d_hid=64, nlayers=3),
                                 seed=0, std=0.3)
    detector = BeatDetector(config, params=params, device="cpu")
    want = detector.detect(features)
    assert detector.detect(npy, cleanup_input=False) == want
    assert npy.exists()
    out_json = tmp_path / "beat_pred.json"
    assert detector.detect(npy, output_json_path=out_json) == want
    assert not npy.exists() and out_json.exists()
