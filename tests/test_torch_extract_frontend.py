"""The port's Extract front end against the JAX package on the same numpy
inputs: the log-mel (etude_tpu_torch/ops/mel.py `log_mel_spectrogram`,
`wav_to_logmel`), the resampler, the volume map (utils/audio.py
`analyze_volume`, `save_volume_map`) and the extractor settings.

Tolerances:
- log-mel: both packages compute the f32 DFT as two matmuls, in different
  summation orders, so the mel power differs by f32 rounding of the frame's
  largest terms: within 2e-6 of the frame's largest mel bin (measured up to
  1.0e-6). In the log, bins near the 1e-8 floor magnify that (up to 0.026
  measured on a piano render with silent frames), so the log is held to
  1e-3 only where a bin lies within 40 dB of its frame's largest.
- resampling: the JAX package evaluates scipy's filter in a native FIR, the
  port calls scipy: equal to 1e-6 (measured 1.2e-7).
- volume map: normalized RMS in [0, 1]; 1e-6.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest

from etude_tpu.config.schema import ExtractorConfig as JaxExtractorConfig
from etude_tpu.data.synthetic import render_piano, synth_piano_notes
from etude_tpu.ops import mel as jax_mel
from etude_tpu.utils import audio as jax_audio
from etude_tpu_torch.config import ExtractorConfig, load_config
from etude_tpu_torch.ops import mel
from etude_tpu_torch.utils import audio

MEL_REL = 2e-6
LOG_ATOL = 1e-3
VOLUME_ATOL = 1e-6


def _piano(seconds=3.0, sr=16000, seed=0):
    rng = np.random.default_rng(seed)
    return render_piano(synth_piano_notes(rng, seconds), seconds, sr=sr)


def _tone(seconds=3.0, sr=16000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    return (0.3 * np.sin(2 * np.pi * 220 * t)
            + 0.02 * rng.normal(size=t.size)).astype(np.float32)


def _assert_log_mel_close(got, want):
    assert got.shape == want.shape
    frame_max = np.exp(want).max(axis=1, keepdims=True)
    excess = np.abs(np.exp(got) - np.exp(want)) - MEL_REL * frame_max
    assert excess.max() <= 0, f"mel power off by {excess.max():.3g} past {MEL_REL} x frame max"
    loud = np.exp(want) > 1e-4 * frame_max
    np.testing.assert_allclose(got[loud], want[loud], atol=LOG_ATOL, rtol=0)


@pytest.mark.parametrize("wave", [
    _piano(), _tone(), _tone()[:1000], _tone()[:100], _tone()[:1],
], ids=["piano", "tone", "shorter_than_fft", "shorter_than_pad", "one_sample"])
def test_log_mel_matches_jax(wave):
    want = np.asarray(jax_mel.log_mel_spectrogram(jnp.asarray(wave)))
    got = mel.log_mel_spectrogram(wave, device="cpu")
    assert got.dtype.is_floating_point and got.device.type == "cpu"
    _assert_log_mel_close(got.numpy(), want)


def test_log_mel_other_settings_match_jax():
    """Narrow mel, a window shorter than the FFT, no centering."""
    kw = dict(sr=8000, n_fft=512, hop=128, win_length=400, n_mels=32, fmin=50.0,
              fmax=3000.0, log_offset=1e-6)
    wave = _tone(1.0, sr=8000)
    for center in (True, False):
        want = np.asarray(jax_mel.log_mel_spectrogram(jnp.asarray(wave), center=center, **kw))
        got = mel.log_mel_spectrogram(wave, center=center, device="cpu", **kw).numpy()
        _assert_log_mel_close(got, want)


def test_wav_to_logmel_uses_the_feature_settings():
    cfg = ExtractorConfig().feature
    cfg.mel_bins, cfg.hop_sample = 64, 512
    jcfg = JaxExtractorConfig().feature
    jcfg.mel_bins, jcfg.hop_sample = 64, 512
    wave = _piano(2.0)
    got = mel.wav_to_logmel(wave, cfg, device="cpu")
    assert isinstance(got, np.ndarray) and got.shape == (2 * 16000 // 512 + 1, 64)
    _assert_log_mel_close(got, jax_mel.wav_to_logmel(wave, jcfg))


@pytest.mark.parametrize("orig,target", [(44100, 16000), (44100, 22050), (22050, 16000)])
def test_resample_matches_jax(orig, target):
    wave = (0.3 * np.random.default_rng(2).standard_normal(orig * 2 + 7)).astype(np.float32)
    got = audio.resample_audio(wave, orig, target)
    want = jax_audio.resample_audio(wave, orig, target)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("sr", [22050, 44100])
def test_volume_map_matches_jax(tmp_path, sr):
    """From the file (resampled to 22.05 kHz on load) and from a shared
    decode (`wave_sr`), as the pipeline calls it; then volume.json."""
    t = np.arange(2 * sr) / sr
    wave = np.concatenate([0.05 * np.sin(2 * np.pi * 220 * t[:sr]),
                           0.9 * np.sin(2 * np.pi * 220 * t[sr:])]).astype(np.float32)
    path = tmp_path / "v.wav"
    audio.save_wav(path, wave, sr)
    want = jax_audio.analyze_volume(path)
    got = audio.analyze_volume(path)
    assert got.dtype == np.float32 and got.shape == want.shape == (41,)
    np.testing.assert_allclose(got, want, atol=VOLUME_ATOL, rtol=0)
    shared = audio.decode_audio(path, target_sr=None)
    np.testing.assert_allclose(audio.analyze_volume(None, wave_sr=shared), want,
                               atol=VOLUME_ATOL, rtol=0)
    audio.save_volume_map(got, tmp_path / "port" / "volume.json")
    jax_audio.save_volume_map(want, tmp_path / "jax" / "volume.json")
    np.testing.assert_allclose(json.loads((tmp_path / "port" / "volume.json").read_text()),
                               json.loads((tmp_path / "jax" / "volume.json").read_text()),
                               atol=VOLUME_ATOL, rtol=0)
    assert got[2:15].mean() < 0.2 and got[25:38].mean() > 0.8


@pytest.mark.parametrize("n", [0, 4410])
def test_volume_map_of_silence_matches_jax(n):
    silence = (np.zeros(n, np.float32), 22050)
    got = audio.analyze_volume(None, wave_sr=silence)
    assert np.array_equal(got, jax_audio.analyze_volume(None, wave_sr=silence))
    assert not got.any()


def test_extractor_settings_are_the_jax_schemas():
    assert dataclasses.asdict(ExtractorConfig()) == JaxExtractorConfig().model_dump()
    config = load_config(None, {"extractor": {"input": {"num_frame": 64},
                                              "infer": {"segment_batch": 2}},
                                "paths": {"extractor_model": "x.ckpt"}})
    assert config.extractor.input.num_frame == 64
    assert config.extractor.infer.segment_batch == 2
    assert str(config.paths.extractor_model) == "x.ckpt"
