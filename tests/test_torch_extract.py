"""The port's extractor (etude_tpu_torch/data/extractor.py) against the JAX
package's (etude_tpu/data/extractor.py), in f32, and mirrors of
tests/test_extractor.py.

Both packages ship the heads off the device as clipped logits rounded to
f16 and peak-pick the sigmoids of those values. Their f32 forwards differ
by rounding (tests/test_torch_amt.py: up to 7.6e-6 on the committed
checkpoint), so a value that lies near the midpoint of two f16 numbers can
round to either: one f16 ulp of the logit, which is what the maps are held
to (measured: 12 of 50,688 map entries differ, each by one ulp). Where the
maps are the same, the notes are equal. `extract.json` through the
committed checkpoint is held to equal pitches, velocities and order, and
times within 1e-4 s (a tenth of a MIDI tick at 120 BPM, 480 ticks per
quarter): one ulp at a peak or beside it moves its interpolated time (by
1.1e-6 s in the measured case).
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etude_tpu.config.schema import ExtractorConfig as JaxExtractorConfig
from etude_tpu.data import extractor as jax_ext
from etude_tpu.data.synthetic import render_piano, synth_piano_notes
from etude_tpu.models import amt as jamt
from etude_tpu_torch.config import ExtractorConfig
from etude_tpu_torch.data import extractor as ext
from etude_tpu_torch.tools.reference_state import amt_state_dict, save_whole_model
from etude_tpu_torch.utils.audio import save_wav
from etude_tpu_torch.utils.midi import read_midi_notes
from etude_tpu_torch.weights import init_amt_params_np
from test_torch_amt import committed_params, jax_f32_extractor  # noqa: F401  (fixtures)

REPO = Path(__file__).resolve().parent.parent
TIME_ATOL = 1e-4


def _small(cls):
    """tests/test_extractor.py's small extractor settings."""
    cfg = cls()
    cfg.feature.mel_bins = cfg.feature.n_bins = 32
    cfg.input.num_frame, cfg.input.margin_b, cfg.input.margin_f = 16, 4, 4
    cfg.model.transformer_hid_dim, cfg.model.transformer_pf_dim = 32, 64
    cfg.model.encoder_n_layer, cfg.model.decoder_n_layer = 1, 2
    cfg.model.cnn_kernel = 3
    cfg.infer.segment_batch = 2
    return cfg


def _committed_settings(cls, n_frame=64, segment_batch=2):
    cfg = cls()
    cfg.input.num_frame, cfg.infer.segment_batch = n_frame, segment_batch
    return cfg


@pytest.fixture(scope="module")
def small():
    """(port extractor, JAX extractor, params) at the small settings, with
    the same random weights."""
    cfg = _small(ExtractorConfig)
    params = init_amt_params_np(ext.amt_config_from(cfg), seed=0)
    return (ext.AMTAPC_Extractor(cfg, params=params, device="cpu"),
            jax_ext.AMTAPC_Extractor(_small(JaxExtractorConfig), params=params), params)


def _piano_wav(path, seconds=3.0, sr=16000, seed=0):
    rng = np.random.default_rng(seed)
    save_wav(path, render_piano(synth_piano_notes(rng, seconds), seconds, sr=sr), sr)
    return path


def _assert_maps_close(got, want):
    """The widened maps: sigmoids of f16 logits equal to one f16 ulp of the
    logit (p(1 − p) times it, plus two f32 ulps of p for the widening);
    velocities equal."""
    assert set(got) == set(want)
    for key, p in want.items():
        assert got[key].shape == p.shape, key
        if key.startswith("velocity"):
            np.testing.assert_array_equal(got[key], p, err_msg=key)
            continue
        logit = np.abs(np.log(p) - np.log1p(-p)).astype(np.float16)
        tol = p * (1 - p) * np.spacing(logit).astype(np.float32) * 1.01 + 2 * np.spacing(p)
        excess = np.abs(got[key] - p) - tol
        assert excess.max() <= 0, f"{key}: {(excess > 0).sum()} entries past one f16 ulp"


def _assert_notes_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a["pitch"], a["velocity"]) == (b["pitch"], b["velocity"])
        assert a["onset"] == pytest.approx(b["onset"], abs=TIME_ATOL)
        assert a["offset"] == pytest.approx(b["offset"], abs=TIME_ATOL)


def test_segments_equal_jax(small):
    port, jax_x, _ = small
    feat = np.random.default_rng(0).normal(size=(40, 32)).astype(np.float32)
    segs, T = port._segment(feat)
    want, want_T = jax_x._segment(feat)
    assert T == want_T == 40 and segs.shape == (3, 32, 24)
    np.testing.assert_array_equal(segs, want)


def test_wire_format_matches_jax():
    """Identical head outputs give the same uint8 velocities and f16 logits
    to one ulp, saturated ones included: the f32 `log` and `log1p` of XLA
    and of PyTorch may differ in their last bit, and then the f16 rounding
    can differ (measured: 1 of 1,232 logits)."""
    rng = np.random.default_rng(5)
    out = {f"{h}_time": rng.uniform(0, 1, size=(2, 7, 88)).astype(np.float32)
           for h in ("onset", "offset", "mpe")}
    out["onset_time"][0, 0, :3] = [0.0, 1.0, 1.0 - 1e-8]
    out["velocity_time"] = rng.normal(size=(2, 7, 88, 128)).astype(np.float32)
    out["velocity_time"][1, 2, 5, [3, 9]] = 50.0    # a tie: the first index wins
    # The JAX post-processing, applied to fixed head outputs.
    orig = jax_ext.forward
    try:
        jax_ext.forward = lambda params, config, spec: {k: jnp.asarray(v) for k, v in out.items()}
        want = jax_ext._transcribe_batch_impl(None, None, None, ("time",))
    finally:
        jax_ext.forward = orig
    got = ext.wire_format({k: torch.from_numpy(v) for k, v in out.items()}, ("time",))
    for key, value in want.items():
        value = np.asarray(value)
        assert got[key].numpy().dtype == value.dtype, key
        if key.startswith("velocity"):
            np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
        else:
            np.testing.assert_array_less(np.abs(got[key].numpy().astype(np.float32) - value),
                                         1.01 * np.spacing(np.abs(value)).astype(np.float32))
    assert got["velocity_time"][1, 2, 5] == 3
    assert got["onset_time"][0, 0, :3].tolist() == [-18.0, 18.0, 18.0]


def test_transcript_matches_jax(small, jax_f32_extractor):  # noqa: F811
    port, jax_x, _ = small
    feat = np.random.default_rng(3).normal(size=(40, 32)).astype(np.float32)
    maps = port._transcript(feat)
    # Padded to the segment boundary, not trimmed to T: 3 segments of 16.
    assert maps["onset_time"].shape == (48, 88)
    _assert_maps_close(maps, jax_x._transcript(feat))
    assert set(port._transcript(feat, branches=("freq", "time"))) == {
        f"{h}_{b}" for h in ("onset", "offset", "mpe", "velocity") for b in ("freq", "time")}


def test_transcript_batched_equals_serial(small):
    """Groups of segments give the maps of one segment at a time, to one
    f16 ulp: the CPU's f32 matmuls round differently at another batch size
    (measured: 4 of 7,040 entries). One group of all the segments gives
    exactly the maps of the model run on `_segment`'s segments: the device
    gather builds the same windows."""
    port, _, params = small
    feat = np.random.default_rng(4).normal(size=(70, 32)).astype(np.float32)

    def maps(batch):
        x = ext.AMTAPC_Extractor(port.config, params=params, segment_batch=batch, device="cpu")
        return x._transcript(feat), x.stats

    batched, stats = maps(2)
    assert stats == {"segments": 5, "groups": 3}
    _assert_maps_close(batched, maps(1)[0])
    whole, stats = maps(5)
    assert stats == {"segments": 5, "groups": 1}
    segs, _ = port._segment(feat)
    with torch.inference_mode():
        out = port.model(torch.from_numpy(segs), torch.float32)
    direct = ext.widen_maps([{k: v.numpy() for k, v in ext.wire_format(out, ("time",)).items()}])
    for key in whole:
        np.testing.assert_array_equal(whole[key], direct[key].reshape(-1, 88), err_msg=key)


def test_peak_picking_of_the_same_maps_equals_jax(small, jax_f32_extractor):  # noqa: F811
    port, jax_x, _ = small
    feat = np.random.default_rng(6).normal(size=(60, 32)).astype(np.float32)
    maps = jax_x._transcript(feat)
    assert port._mpe2note(maps) == jax_x._mpe2note(maps)


def test_extract_json_through_the_committed_checkpoint_matches_jax(
        tmp_path, committed_params, jax_f32_extractor):  # noqa: F811
    wav = _piano_wav(tmp_path / "piano.wav")
    port = ext.AMTAPC_Extractor(_committed_settings(ExtractorConfig),
                                params=committed_params, device="cpu")
    jax_x = jax_ext.AMTAPC_Extractor(_committed_settings(JaxExtractorConfig),
                                     params=committed_params)
    got = port.extract(wav, tmp_path / "port.json", tmp_path / "port.mid")
    want = jax_x.extract(wav, tmp_path / "jax.json")
    assert want, "the piano render should give the committed extractor notes"
    _assert_notes_close(json.loads((tmp_path / "port.json").read_text()),
                        json.loads((tmp_path / "jax.json").read_text()))
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert port.stats["notes_kept"] == len(got) <= port.stats["notes_picked"]
    assert all(n["offset"] - n["onset"] >= 0.08 for n in got)
    assert len(read_midi_notes(tmp_path / "port.mid")) == len(got)
    # The same features give the same maps to one f16 ulp.
    feature = np.asarray(jax_x._wav2feature(wav))
    _assert_maps_close(port._transcript(feature), jax_x._transcript(feature))


def test_wav2feature_from_a_shared_decode(small, tmp_path):
    port, _, _ = small
    wav = _piano_wav(tmp_path / "a.wav", seconds=1.2, sr=44100)
    from_file = port._wav2feature(wav)
    from_wave = port._wav2feature(None, wave_sr=ext.decode_audio(wav, target_sr=None))
    assert from_file.shape == (1.2 * 16000 // 256 + 1, 32)
    torch.testing.assert_close(from_wave, from_file, rtol=0, atol=0)


def test_weights_follow_the_loader_rules(tmp_path):
    cfg = _small(ExtractorConfig)
    with pytest.raises(RuntimeError, match="orbax"):
        ext.AMTAPC_Extractor(ExtractorConfig(), model_path=REPO / "checkpoints/extractor/latest.ckpt",
                             device="cpu")
    # Reference files, a state dict and a pickled whole model, are converted.
    tree = init_amt_params_np(ext.amt_config_from(cfg), seed=5)
    state = amt_state_dict(tree, ext.amt_config_from(cfg))
    torch.save(state, tmp_path / "hft.pth")
    save_whole_model(state, tmp_path / "hft.pkl")
    for suffix in (".pth", ".pkl"):
        ref = ext.AMTAPC_Extractor(cfg, model_path=tmp_path / f"hft{suffix}", device="cpu")
        np.testing.assert_array_equal(ref.model.note_query.numpy(), tree["note_query"])
    missing = tmp_path / "none.ckpt"
    with pytest.raises(FileNotFoundError):
        ext.AMTAPC_Extractor(cfg, model_path=missing, device="cpu")
    random = ext.AMTAPC_Extractor(cfg, model_path=missing, device="cpu",
                                  allow_random_weights=True)
    expect = init_amt_params_np(ext.amt_config_from(cfg), seed=0)
    np.testing.assert_array_equal(random.model.note_query.numpy(), expect["note_query"])


def test_extractor_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ext.AMTAPC_Extractor(_small(ExtractorConfig), allow_random_weights=True)


def test_jax_forward_fixture_is_f32(jax_f32_extractor):  # noqa: F811
    """The fixture reaches the forward the JAX extractor calls."""
    assert jax_ext.forward.keywords == {"compute_dtype": jnp.float32}
    assert jax_ext.forward.func is jamt.forward
