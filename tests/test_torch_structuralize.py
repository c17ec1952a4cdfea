"""The port's Structuralize stage (etude_tpu_torch/infer.py
`_run_stage2_structuralize`, data/beat_analyzer.py) against the JAX package:
the BeatAnalyzer mirrors of tests/test_structuralize.py, and one whole-slice
run of a click track through the committed checkpoints on both sides.

Whole slice, in f32 on both sides (the JAX U-Net and beat model are held
to f32 by the fixtures of the per-module tests): separation features to
1e-2 dB and beat activations to 1e-3 (two f16 ulps near 1; see
tests/test_torch_separation.py and tests/test_torch_beat_transformer.py),
then `beat_pred.json` and `tempo.json` equal.
"""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from etude_tpu.config.schema import BeatDetectorConfig as JaxBeatDetectorConfig
from etude_tpu.data import beat_detector as jax_bd
from etude_tpu.data import separation as jax_sep
from etude_tpu.data.beat_analyzer import BeatAnalyzer as JaxBeatAnalyzer
from etude_tpu.models import beat_transformer as jbt
from etude_tpu.models import separator as jsep
from etude_tpu.utils.training import load_params_only
from etude_tpu_torch import infer
from etude_tpu_torch.config import load_config
from etude_tpu_torch.data import beat_detector, separation
from etude_tpu_torch.data.beat_analyzer import BeatAnalyzer
from etude_tpu_torch.utils import model_loader
from etude_tpu_torch.utils.audio import save_wav
from test_torch_beat_transformer import jax_f32_detector  # noqa: F401  (fixture)
from test_torch_separation import jax_f32_separator  # noqa: F401  (fixture)

REPO = Path(__file__).resolve().parent.parent


# ----------------------------------------------------------- beat analyzer
def _make_preds(bpm=120.0, time_sig=4, n_bars=16, start=0.5):
    spb = 60.0 / bpm
    beats, downbeats = [], []
    for bar in range(n_bars):
        t0 = start + bar * time_sig * spb
        downbeats.append(round(t0, 6))
        for b in range(1, time_sig):
            beats.append(round(t0 + b * spb, 6))
    return beats, downbeats


def _gap_preds():
    beats_a, downbeats_a = _make_preds(bpm=120, time_sig=4, n_bars=8, start=0.0)
    beats_b, downbeats_b = _make_preds(bpm=120, time_sig=4, n_bars=8, start=20.0)
    return beats_a + beats_b, downbeats_a + downbeats_b


ANALYZER_CASES = {
    "steady": _make_preds(bpm=120, time_sig=4, n_bars=16),
    "two_four": _make_preds(bpm=120, time_sig=2, n_bars=20),
    "triple": _make_preds(bpm=90, time_sig=3, n_bars=20),
    "gap": _gap_preds(),
    "no_downbeats": ([1.0, 2.0], []),
    "half_bar_gap": (_make_preds(n_bars=6, start=0.0)[0] + _make_preds(n_bars=6, start=13.0)[0],
                     _make_preds(n_bars=6, start=0.0)[1] + _make_preds(n_bars=6, start=13.0)[1]),
}


@pytest.mark.parametrize("case", sorted(ANALYZER_CASES))
def test_beat_analyzer_matches_jax(case):
    beats, downbeats = ANALYZER_CASES[case]
    assert (BeatAnalyzer().analyze_predictions(beats, downbeats)
            == JaxBeatAnalyzer().analyze_predictions(beats, downbeats))


def test_beat_analyzer_contract():
    """Mirrors of tests/test_structuralize.py's analyzer tests."""
    steady = BeatAnalyzer().analyze_predictions(*ANALYZER_CASES["steady"])
    assert len(steady) == 1 and steady[0]["time_sig"] == 4
    assert steady[0]["bpm"] == pytest.approx(120.0, rel=1e-3)
    assert steady[0]["start"] == pytest.approx(0.5)
    assert len(steady[0]["downbeats"]) == 14
    assert BeatAnalyzer().analyze_predictions(*ANALYZER_CASES["two_four"])[0]["time_sig"] == 4
    triple = BeatAnalyzer().analyze_predictions(*ANALYZER_CASES["triple"])
    assert triple[0]["time_sig"] == 3
    assert triple[0]["bpm"] == pytest.approx(90.0, rel=1e-3)
    gap = BeatAnalyzer().analyze_predictions(*ANALYZER_CASES["gap"])
    downbeats = [db for r in gap for db in r["downbeats"]]
    assert min(downbeats) == pytest.approx(0.0)
    assert any(abs(db - 20.0) < 0.01 for db in downbeats)
    assert any(14.0 < db < 20.0 for db in downbeats)
    assert gap[-1]["bpm"] == pytest.approx(120.0, rel=1e-3)


def test_beat_analyzer_json_roundtrip(tmp_path):
    beats, downbeats = _make_preds()
    pred = tmp_path / "beat_pred.json"
    pred.write_text(json.dumps({"beat_pred": beats, "downbeat_pred": downbeats}))
    analyzer = BeatAnalyzer()
    regions = analyzer.analyze(pred)
    out = tmp_path / "tempo.json"
    analyzer.save_tempo_data(regions, out)
    assert json.loads(out.read_text()) == regions


# -------------------------------------------------------------- whole slice
def _click_track(path, seconds=12.0, sr=44100, bpm=120.0):
    """Noise floor, an 880 Hz click per beat, a louder 1760 Hz one per bar."""
    rng = np.random.default_rng(0)
    wave = 0.01 * rng.standard_normal(int(seconds * sr))
    n = int(0.03 * sr)
    t = np.arange(n) / sr
    for i, start in enumerate(np.arange(0.25, seconds - 0.05, 60.0 / bpm)):
        s = int(start * sr)
        down = i % 4 == 0
        click = (0.8 if down else 0.4) * np.exp(-t / 0.005) * np.sin(
            2 * np.pi * (1760 if down else 880) * t)
        wave[s:s + n] += click[:len(wave) - s]
    save_wav(path, wave.astype(np.float32), sr)


def _committed(kind):
    if kind == "separator":
        path, init = "separator", lambda: jsep.init_params(jsep.SeparatorConfig(), seed=0)
    else:
        path, init = "beat_detector", lambda: jbt.init_params(jbt.BeatTransformerConfig(), seed=0)
    params = load_params_only(REPO / "checkpoints" / path / "latest.ckpt",
                              jax.eval_shape(init))
    return jax.tree.map(np.asarray, params)


def _settings(tmp_path, **paths):
    return load_config(None, {"paths": {"infer_output_dir": str(tmp_path / "out"),
                                        **{k: str(v) for k, v in paths.items()}}})


def test_whole_slice_matches_jax(tmp_path, monkeypatch, jax_f32_separator,  # noqa: F811
                                 jax_f32_detector):  # noqa: F811
    wav = tmp_path / "click.wav"
    _click_track(wav)
    sep_params, beat_params = _committed("separator"), _committed("beat")

    # JAX: SourceSeparator → BeatDetector.detect → BeatAnalyzer.
    jax_features = jax_sep.SourceSeparator(params=sep_params).separate_features(wav)
    detector = jax_bd.BeatDetector(JaxBeatDetectorConfig(), params=beat_params)
    jax_act = detector.activations(jax_features)
    jax_beats = detector.detect(jax_features, tmp_path / "jax_beat_pred.json")
    analyzer = JaxBeatAnalyzer()
    jax_tempo = analyzer.analyze(tmp_path / "jax_beat_pred.json")
    assert jax_tempo, "the click track should give the JAX package a tempo map"

    # The port's entry point on the CPU, with the committed weights handed
    # to its loader (the orbax files themselves are not readable there).
    trees = {"separator": sep_params, "beat model": beat_params}
    monkeypatch.setattr(model_loader, "load_params",
                        lambda what, *args, **kw: trees[what])
    seen = {}
    for module, name, key in ((separation.SourceSeparator, "separate_features", "features"),
                              (beat_detector.BeatDetector, "activations", "act")):
        original = getattr(module, name)

        def spy(self, *args, _original=original, _key=key, **kw):
            out = _original(self, *args, **kw)
            seen[_key] = out
            return out

        monkeypatch.setattr(module, name, spy)
    pipeline = infer.InferencePipeline(_settings(tmp_path), device="cpu")
    pipeline._run_stage2_structuralize(wav)

    features = seen["features"]
    assert isinstance(features, torch.Tensor) and features.device.type == "cpu"
    np.testing.assert_allclose(features.numpy(), jax_features, atol=1e-2, rtol=0)
    np.testing.assert_allclose(seen["act"], jax_act, atol=1e-3, rtol=0)
    work = pipeline.work_dir
    assert json.loads((work / "beat_pred.json").read_text()) == jax_beats
    assert json.loads((work / "tempo.json").read_text()) == jax_tempo
    assert set(pipeline.timer.summary()) == {
        "sep: wav decode", "sep: STFT + U-Net + mel", "sep: power to dB",
        "beat: forward", "beat: DBN decode", "tempo: analysis"}


def test_structuralize_without_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        infer.InferencePipeline(_settings(tmp_path), allow_random_weights=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        separation.SourceSeparator(allow_random_weights=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        beat_detector.BeatDetector(beat_detector.BeatDetectorConfig(),
                                   allow_random_weights=True)


def test_committed_orbax_checkpoints_raise(tmp_path):
    wav = tmp_path / "click.wav"
    _click_track(wav, seconds=2.0)
    pipeline = infer.InferencePipeline(_settings(
        tmp_path, separator_model=REPO / "checkpoints/separator/latest.ckpt"), device="cpu")
    with pytest.raises(RuntimeError, match="orbax"):
        pipeline._run_stage2_structuralize(wav)
    assert not (pipeline.work_dir / "tempo.json").exists()


def test_missing_weights_need_the_flag(tmp_path):
    none = tmp_path / "none.ckpt"
    pipeline = infer.InferencePipeline(
        _settings(tmp_path, separator_model=none, beat_detector_model=none), device="cpu")
    with pytest.raises(SystemExit):
        pipeline._require_weights("structuralize")
    with pytest.raises(FileNotFoundError):
        pipeline._run_stage2_structuralize(tmp_path / "unused.wav")


def test_settings_file_sets_beat_detector_fields(tmp_path):
    settings = tmp_path / "s.json"
    settings.write_text(json.dumps({"beat_detector": {
        "min_bpm": 60, "beats_per_bar": [2, 3, 4], "octave_disambiguation": True,
        "model": {"nlayers": 3}}, "separator": {"depth": 4}}))
    config = load_config(settings)
    bd = config.beat_detector
    assert (bd.min_bpm, bd.beats_per_bar, bd.octave_disambiguation) == (60.0, [2, 3, 4], True)
    assert bd.model.nlayers == 3 and config.separator.depth == 4
    # The defaults are the JAX schema's.
    from etude_tpu.config.schema import SeparatorConfig as JaxSeparatorSettings

    defaults = load_config()
    assert dataclasses.asdict(defaults.beat_detector) == JaxBeatDetectorConfig().model_dump()
    assert dataclasses.asdict(defaults.separator) == JaxSeparatorSettings().model_dump()
