"""The port's dataset preparation (etude_tpu_torch/prepare.py, data/hft.py,
utils/preprocess.py) against the JAX package's (the root prepare.py,
etude_tpu/data/hft.py, etude_tpu/utils/preprocess.py), on the CPU, on the
same inputs, with the JAX models held to f32 by the per-module tests'
fixtures.

Tolerances:
- The preprocess helpers, `metadata.json`, `cover.json`, `wp.json`,
  `vocab.json`, the tokenized ids, `beat_pred.json` and `tempo.json`:
  equal.
- The hFT stride maps: the heads leave the model as f16 logits in both
  packages (data/extractor.py `wire_format`), so a logit whose f32 value
  lies near the middle of two f16 numbers can round either way, and its
  sigmoid then moves by p(1 − p) times one f16 ulp (measured 1.5e-5 on
  one such flip at the narrow width). The maps are held as
  tests/test_torch_extract.py holds them, within one f16 ulp of the logit
  (of the larger logit, for a flip across a binade's edge), velocities
  equal.
- `transcription.json` and `extract.json`: equal pitches, velocities and
  order, times within 1e-4 s (tests/test_torch_extract.py's TIME_ATOL),
  through the committed extractor checkpoint (the hFT transcriber is the
  same model). Under random weights the heads sit near p = 0.5, where one
  f16 flip adds or removes a note, so notes are compared only through
  trained weights.
"""

import dataclasses
import functools
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import etude_tpu.data.hft as jax_hft
import etude_tpu.utils.preprocess as jax_pre
from etude_tpu.config import load_config as jax_load_config
from etude_tpu.config.schema import HFTConfig as JaxHFTConfig
import etude_tpu_torch.data.hft as hft
from etude_tpu_torch import prepare
from etude_tpu_torch.config import HFTConfig
from etude_tpu_torch.tools.reference_state import amt_state_dict, save_whole_model
from etude_tpu_torch.utils import model_loader
from etude_tpu_torch.utils import preprocess as pre
from etude_tpu_torch.utils.audio import save_wav
from etude_tpu_torch.weights import init_amt_params_np
from test_torch_align import piano_pair
from test_torch_amt import committed_params, jax_f32_extractor  # noqa: F401  (fixtures)
from test_torch_beat_transformer import jax_f32_detector  # noqa: F401  (fixture)
from test_torch_extract import _assert_notes_close
from test_torch_separation import jax_f32_separator  # noqa: F401  (fixture)
from test_torch_structuralize import _committed

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import prepare as jax_prepare  # noqa: E402  (the root CLI)

NARROW = dict(cnn_kernel=3, hid_dim=32, pf_dim=64, encoder_n_layer=1, decoder_n_layer=2)
HFT_SMALL = {"feature": {"mel_bins": 32, "n_bins": 32},
             "input": {"num_frame": 16, "margin_b": 4, "margin_f": 4},
             "infer": {"n_stride": 8, "thred_onset": 0.5, "thred_offset": 0.5,
                       "thred_mpe": 0.5}}


# ---- preprocess helpers ---------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_preprocess_helpers_equal_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(50, 400))
    cover = np.sort(rng.choice(3 * n, size=n, replace=False))
    origin = np.sort(rng.choice(3 * n, size=n, replace=False))
    align = {"wp": np.stack([cover, origin])}
    downbeats = list(np.sort(rng.uniform(-1.0, origin[-1] / 50 + 2.0, size=30)))
    time_map = pre.create_time_map_from_downbeats(downbeats, align)
    assert time_map == jax_pre.create_time_map_from_downbeats(downbeats, align)
    assert pre.compute_wp_std(time_map) == jax_pre.compute_wp_std(time_map)
    notes = [{"pitch": int(rng.integers(21, 109)), "onset": float(t),
              "offset": float(t + rng.uniform(0.05, 1.0)), "velocity": int(rng.integers(1, 128))}
             for t in rng.uniform(-1.0, cover[-1] / 50 + 12.0, size=80)]
    assert pre.weakly_align(notes, time_map) == jax_pre.weakly_align(notes, time_map)
    assert pre.compute_wp_std([]) == jax_pre.compute_wp_std([]) == float("inf")
    assert pre.weakly_align([], time_map) == [] and pre.weakly_align(notes, []) == []


# ---- the hFT transcriber ------------------------------------------------

def _small_hft(cls):
    cfg = cls()
    for section, values in HFT_SMALL.items():
        for key, value in values.items():
            setattr(getattr(cfg, section), key, value)
    return cfg


@pytest.fixture
def narrow(monkeypatch):
    """Both packages' `hft_amt_config` gives the narrow widths."""
    for module in (jax_hft, hft):
        real = module.hft_amt_config
        monkeypatch.setattr(module, "hft_amt_config",
                            lambda cfg, real=real: dataclasses.replace(real(cfg), **NARROW))


def _hft_pair(segment_batch=2):
    """(port, JAX) transcribers at the small settings and narrow widths with
    the same random weights, and those weights."""
    cfg = _small_hft(HFTConfig)
    params = init_amt_params_np(hft.hft_amt_config(cfg), seed=0)
    port = hft.HFT_Transformer(cfg, params=params, segment_batch=segment_batch, device="cpu")
    jax_x = jax_hft.HFT_Transformer(_small_hft(JaxHFTConfig), params=params,
                                    segment_batch=segment_batch)
    return port, jax_x, params


def _assert_maps_within_one_f16_ulp(got, want):
    """Velocities equal; each sigmoid within one f16 ulp of the larger of
    the two logits (a flip at the edge of a binade is one ulp of the
    larger), as p(1 − p) times it, plus two f32 ulps of p on each side for
    the widening: near p = 0.5, 1 + exp(−x) lies in [2, 4), where one f32
    ulp is two of p."""
    assert set(got) == set(want)
    for key, p in want.items():
        assert got[key].shape == p.shape, key
        if key.startswith("velocity"):
            np.testing.assert_array_equal(got[key], p, err_msg=key)
            continue
        ulp = np.maximum(*(np.spacing(np.abs(np.log(q) - np.log1p(-q)).astype(np.float16))
                           .astype(np.float32) for q in (p, got[key])))
        tol = p * (1 - p) * ulp * 1.01 + 4 * np.spacing(p)
        excess = np.abs(got[key] - p) - tol
        assert excess.max() <= 0, f"{key}: {(excess > 0).sum()} entries past one f16 ulp"


@pytest.mark.parametrize("T,segment_batch", [(50, 2), (64, 3), (5, 2)])
def test_stride_maps_equal_jax(T, segment_batch, narrow, jax_f32_extractor):  # noqa: F811
    port, jax_x, _ = _hft_pair(segment_batch)
    feature = np.random.default_rng(T).normal(size=(T, 32)).astype(np.float32)
    got = port._transcript_stride(feature)
    want = jax_x._transcript_stride(feature)
    assert got["onset_time"].shape == (T, 88) and got["velocity_time"].shape == (T, 88)
    _assert_maps_within_one_f16_ulp(got, want)
    n_chunks = -(-T // 8)
    assert port.stats == {"segments": n_chunks, "groups": -(-n_chunks // segment_batch)}


def _hft_settings(cls):
    """The HFT settings at 64-frame segments (stride 32), so that the
    full-width model stays quick on a CPU."""
    cfg = cls()
    cfg.input.num_frame, cfg.infer.n_stride = 64, 32
    return cfg


def test_transcription_json_equals_jax(tmp_path, committed_params,  # noqa: F811
                                       jax_f32_extractor):  # noqa: F811
    _, cover = piano_pair(0, seconds=2.0, sr=16000)
    save_wav(tmp_path / "cover.wav", cover, 16000)
    port = hft.HFT_Transformer(_hft_settings(HFTConfig), params=committed_params,
                               segment_batch=2, device="cpu")
    got = port.transcribe(tmp_path / "cover.wav", tmp_path / "port.json", tmp_path / "port.mid")
    jax_hft.HFT_Transformer(_hft_settings(JaxHFTConfig), params=committed_params,
                            segment_batch=2).transcribe(tmp_path / "cover.wav",
                                                        tmp_path / "jax.json")
    want = json.loads((tmp_path / "jax.json").read_text())
    assert want, "the committed transcriber should pick notes of the piano render"
    loaded = json.loads((tmp_path / "port.json").read_text())
    _assert_notes_close(loaded, want)
    assert [list(n) for n in loaded] == [["onset", "offset", "pitch", "velocity"]] * len(loaded)
    assert len(got) == len(loaded) and (tmp_path / "port.mid").exists()
    assert port.stats["notes"] == len(loaded)
    assert port.stats["groups"] == -(-port.stats["segments"] // 2)


def test_reference_pkl_gives_the_same_maps(tmp_path, narrow):
    """A reference whole-model .pkl of the same weights gives the same
    maps."""
    port, _, params = _hft_pair()
    save_whole_model(amt_state_dict(params, port.amt_config), tmp_path / "latest.pkl")
    from_pkl = hft.HFT_Transformer(port.config, model_path=tmp_path / "latest.pkl",
                                   segment_batch=2, device="cpu")
    feature = np.random.default_rng(9).normal(size=(40, 32)).astype(np.float32)
    a, b = from_pkl._transcript_stride(feature), port._transcript_stride(feature)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_missing_hft_checkpoint_raises_without_random_weights(tmp_path):
    with pytest.raises(FileNotFoundError, match="allow_random_weights"):
        hft.HFT_Transformer(HFTConfig(), model_path=tmp_path / "none.ckpt", device="cpu")


# ---- the CLI, stages 3-5 ------------------------------------------------

def _settings(tmp_path, side, **extra):
    """The same settings for both CLIs (JSON is YAML for the JAX loader):
    the corpus dirs of `side`; the committed extractor, separator and beat
    checkpoints (the port gets their trees through its loader); the
    extractor and the hFT at 64-frame segments; the WP-Std filter set high
    enough to keep a hand-written grid."""
    root = tmp_path / side
    settings = {
        "paths": {
            "raw_dir": str(tmp_path / "raw"),
            "processed_dir": str(root / "processed"),
            "aligned_dir": str(root / "aligned"),
            "tokenized_dir": str(root / "tokenized"),
            "dataset_vocab": str(root / "vocab.json"),
            "extractor_model": str(REPO / "checkpoints/extractor/latest.ckpt"),
            "hft_model": str(tmp_path / "no_hft.ckpt"),
            "separator_model": str(REPO / "checkpoints/separator/latest.ckpt"),
            "beat_detector_model": str(REPO / "checkpoints/beat_detector/latest.ckpt"),
        },
        "extractor": {"input": {"num_frame": 64}, "infer": {"segment_batch": 2}},
        "hft": {"input": {"num_frame": 64}, "infer": {"n_stride": 32}},
        "prepare": {"align": {"wp_std_threshold": 100.0}},
        **extra,
    }
    path = tmp_path / f"{side}.json"
    path.write_text(json.dumps(settings))
    return path


def _corpus(tmp_path, processed_sides=("jax", "port"), seconds=3.0):
    """Two songs under raw/: a piano render at 22.05 kHz and its cover,
    transposed and time-warped; each side's processed/ holds the stage 2
    outputs written from the renders' notes."""
    for k, (seed, transpose) in enumerate(((0, 2), (1, -3))):
        name = f"{k + 1:04d}"
        origin, cover = piano_pair(seed, seconds=seconds, transpose=transpose)
        save_wav(tmp_path / "raw" / name / "origin.wav", origin, 22050)
        save_wav(tmp_path / "raw" / name / "cover.wav", cover, 22050)
        rng = np.random.default_rng(seed)
        notes = [{"onset": round(t, 4), "offset": round(t + 0.3, 4),
                  "pitch": int(p), "velocity": 80}
                 for t, p in zip(np.sort(rng.uniform(0.1, seconds * 1.2, 40)),
                                 rng.integers(40, 90, 40))]
        downbeats = [0.5 + 2.0 * i for i in range(int(seconds / 2))]
        for side in processed_sides:
            out = tmp_path / side / "processed" / name
            out.mkdir(parents=True)
            (out / "beat_pred.json").write_text(json.dumps(
                {"beat_pred": [0.5 + 0.5 * i for i in range(int(2 * seconds) - 1)],
                 "downbeat_pred": downbeats}))
            (out / "transcription.json").write_text(json.dumps(notes))
            (out / "tempo.json").write_text(json.dumps(
                [{"time_sig": 4, "bpm": 120.0, "start": 0.5, "downbeats": downbeats}]))


def _read(root, rel):
    return json.loads((root / rel).read_text())


@pytest.fixture
def committed_trees(monkeypatch, committed_params):  # noqa: F811
    """The port's loader hands out the committed trees (the orbax files
    themselves are not readable there), as tests/test_torch_pipeline.py
    does."""
    trees = {"extractor": committed_params, "hft transcriber": committed_params,
             "separator": _committed("separator"), "beat model": _committed("beat")}
    load = model_loader.load_params
    monkeypatch.setattr(model_loader, "load_params",
                        lambda what, *a, **kw: trees[what] if what in trees else load(what, *a, **kw))
    return trees


def test_stages_3_to_5_equal_jax(tmp_path, committed_trees,
                                 jax_f32_extractor):  # noqa: F811
    _corpus(tmp_path)
    jax_cfg = jax_load_config(_settings(tmp_path, "jax"))
    port_settings = str(_settings(tmp_path, "port"))

    def port(stage):
        return prepare.main(["--config", port_settings, "--run-only", stage,
                             "--allow-random-weights", "--device", "cpu"])

    jax_prepare.run_stage_3_align_and_filter(jax_cfg)
    assert port("align") == 0
    jax_root, root = tmp_path / "jax", tmp_path / "port"
    meta = _read(root, "aligned/metadata.json")
    assert meta == _read(jax_root, "aligned/metadata.json")
    assert [m["dir_name"] for m in meta] == ["0001", "0002"]
    for name in ("0001", "0002"):
        assert _read(root, f"aligned/{name}/cover.json") == _read(
            jax_root, f"aligned/{name}/cover.json")
        assert _read(root, f"processed/{name}/wp.json") == _read(
            jax_root, f"processed/{name}/wp.json")
        assert _read(root, f"aligned/{name}/cover.json")

    jax_prepare.run_stage_4_extract(jax_cfg)
    assert port("extract") == 0
    for name in ("0001", "0002"):
        want = _read(jax_root, f"aligned/{name}/extract.json")
        assert want, "the committed extractor should keep notes of the piano render"
        _assert_notes_close(_read(root, f"aligned/{name}/extract.json"), want)
        # Stage 5 is held on the same inputs.
        shutil.copy(jax_root / f"aligned/{name}/extract.json",
                    root / f"aligned/{name}/extract.json")

    jax_prepare.run_stage_5_tokenize(jax_cfg)
    assert port("tokenize") == 0
    assert _read(root, "vocab.json") == _read(jax_root, "vocab.json")
    for i in (1, 2):
        for side in ("src", "tgt"):
            rel = f"tokenized/{i:04d}/{i:04d}_{side}.npy"
            got, want = np.load(root / rel), np.load(jax_root / rel)
            assert got.dtype == want.dtype == np.int32 and got.size > 10
            np.testing.assert_array_equal(got, want)

    # Idempotent: a rerun of stage 3 skips the songs and keeps them.
    assert port("align") == 0
    assert [m["dir_name"] for m in _read(root, "aligned/metadata.json")] == ["0001", "0002"]


def test_tokenize_json_format_and_existing_vocab(tmp_path):
    """`prepare.tokenize.save_format: json` writes id lists; an existing
    vocab is read, not rebuilt."""
    _corpus(tmp_path, processed_sides=("port",), seconds=4.0)
    settings = _settings(tmp_path, "port", prepare={
        "align": {"wp_std_threshold": 100.0}, "tokenize": {"save_format": "json"}})
    rc = prepare.main(["--config", str(settings), "--run-only", "align", "--device", "cpu"])
    assert rc == 0
    root = tmp_path / "port"
    for name in ("0001", "0002"):
        shutil.copy(root / f"aligned/{name}/cover.json", root / f"aligned/{name}/extract.json")
    assert prepare.main(["--config", str(settings), "--run-only", "tokenize",
                         "--device", "cpu"]) == 0
    ids = _read(root, "tokenized/0001/0001_src.json")
    assert ids and all(isinstance(i, int) for i in ids)
    vocab_text = (root / "vocab.json").read_text()
    shutil.rmtree(root / "tokenized")
    assert prepare.main(["--config", str(settings), "--run-only", "tokenize",
                         "--device", "cpu"]) == 0
    assert (root / "vocab.json").read_text() == vocab_text
    assert _read(root, "tokenized/0001/0001_src.json") == ids


def test_tokenize_with_no_pairs_exits_1(tmp_path):
    settings = _settings(tmp_path, "port")
    (tmp_path / "port" / "aligned").mkdir(parents=True)
    (tmp_path / "port" / "aligned" / "metadata.json").write_text("[]")
    with pytest.raises(SystemExit) as exc:
        prepare.main(["--config", str(settings), "--run-only", "tokenize", "--device", "cpu"])
    assert exc.value.code == 1


# ---- the CLI, stage 2 ---------------------------------------------------

def test_stage_2_equals_jax(tmp_path, monkeypatch, committed_trees,  # noqa: F811
                            jax_f32_extractor, jax_f32_separator,  # noqa: F811
                            jax_f32_detector):  # noqa: F811
    """Stage 2 of both CLIs on one song, with the committed separator, beat
    and extractor checkpoints (the hFT transcriber is the extractor's
    model), the transcribers two segments at a time on both sides (stage 2
    makes them with 16, minutes of CPU at full width)."""
    origin, _ = piano_pair(4, seconds=4.0, sr=44100)
    save_wav(tmp_path / "raw" / "0001" / "origin.wav", origin, 44100)
    save_wav(tmp_path / "raw" / "0001" / "cover.wav", piano_pair(4, seconds=1.5, sr=16000)[1],
             16000)
    jax_params = committed_trees["hft transcriber"]
    monkeypatch.setattr(jax_prepare, "HFT_Transformer", lambda cfg, model_path=None:
                        jax_hft.HFT_Transformer(cfg, params=jax_params, segment_batch=2))
    monkeypatch.setattr(prepare, "HFT_Transformer",
                        functools.partial(hft.HFT_Transformer, segment_batch=2))

    jax_prepare.run_stage_2_preprocess(jax_load_config(_settings(tmp_path, "jax")))
    timer = prepare.StageTimer(torch.device("cpu"))
    rc = prepare.main(["--config", str(_settings(tmp_path, "port")), "--run-only", "preprocess",
                       "--allow-random-weights", "--device", "cpu"], timer=timer)
    assert rc == 0
    assert {"stage preprocess", "preprocess: models", "preprocess 0001: transcription",
            "preprocess 0001: beat grid", "hft: forward"} <= set(timer.summary())
    got, want = tmp_path / "port/processed/0001", tmp_path / "jax/processed/0001"
    assert _read(got, "beat_pred.json") == _read(want, "beat_pred.json")
    assert _read(got, "tempo.json") == _read(want, "tempo.json")
    assert _read(want, "transcription.json"), "the committed transcriber should pick notes"
    _assert_notes_close(_read(got, "transcription.json"), _read(want, "transcription.json"))


# ---- refusals -----------------------------------------------------------

def test_missing_checkpoints_are_refused(tmp_path, monkeypatch):
    """Without --allow-random-weights a missing checkpoint of a stage to run
    exits 1 before any device is touched; the stages that load no model
    run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    settings = _settings(tmp_path, "port")
    assert prepare.main(["--config", str(settings), "--start-from", "preprocess"]) == 1
    no_extractor = tmp_path / "no_extractor.json"
    no_extractor.write_text(json.dumps({"paths": {"extractor_model": str(tmp_path / "none")}}))
    assert prepare.main(["--config", str(no_extractor), "--run-only", "extract"]) == 1
    _corpus(tmp_path, processed_sides=("port",), seconds=4.0)
    assert prepare.main(["--config", str(settings), "--run-only", "align",
                         "--device", "cpu"]) == 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare.main(["--config", str(settings), "--run-only", "align"])


def test_stage_1_raises(tmp_path):
    settings = _settings(tmp_path, "port")
    with pytest.raises(NotImplementedError, match="network"):
        prepare.main(["--config", str(settings), "--allow-random-weights", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="network"):
        prepare.main(["--config", str(settings), "--run-only", "download", "--device", "cpu"])
