"""The port's whole `--input` pipeline (etude_tpu_torch/infer.py `run`:
Extract ∥ Structuralize ∥ volume, then Decode) against the JAX package's
(infer.py `InferencePipeline.run`) on one 44.1 kHz song, on the CPU, with
the committed extractor, separator and beat checkpoints on both sides and
the JAX models held to f32 by the fixtures of the per-module tests.

Held: `tempo.json` and `beat_pred.json` equal; `extract.json` with equal
pitches, velocities and order and times within 1e-4 s (the f16 wire
format's one-ulp flips, tests/test_torch_extract.py); `volume.json` to
1e-6 (tests/test_torch_extract_frontend.py); the MIDI parses. The decoder
is a tiny random one: its tokens are not compared here (tests/
test_torch_generate_stream.py holds the engine).
"""

import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from etude_tpu.config import load_config as jax_load_config
from etude_tpu.data.synthetic import render_piano, synth_piano_notes
from etude_tpu.models.decoder import EtudeDecoderConfig as JaxDecoderConfig
from etude_tpu_torch import infer
from etude_tpu_torch.config import load_config
from etude_tpu_torch.utils import model_loader
from etude_tpu_torch.utils.audio import save_wav
from etude_tpu_torch.utils.midi import read_midi_notes
from etude_tpu_torch.utils.profiling import StageTimer, trace
from infer import InferencePipeline as JaxInferencePipeline
from test_infer_pipeline import _build_vocab
from test_torch_amt import committed_params, jax_f32_extractor  # noqa: F401  (fixtures)
from test_torch_beat_transformer import jax_f32_detector  # noqa: F401  (fixture)
from test_torch_extract import TIME_ATOL
from test_torch_separation import jax_f32_separator  # noqa: F401  (fixture)
from test_torch_structuralize import _committed

REPO = Path(__file__).resolve().parent.parent
ATTRS = {"polyphony_bin": 1, "rhythm_intensity_bin": 1, "sustain_bin": 1,
         "pitch_overlap_bin": 2}
OUTPUTS = ("extract.json", "volume.json", "beat_pred.json", "tempo.json")


def _song(path, seconds=10.0, sr=44100, bpm=150.0):
    """A piano render over a click track, as 16-bit PCM at 44.1 kHz."""
    rng = np.random.default_rng(7)
    wave = render_piano(synth_piano_notes(rng, seconds, notes_per_sec=2.0), seconds, sr=sr)
    n = int(0.03 * sr)
    t = np.arange(n) / sr
    for i, start in enumerate(np.arange(0.25, seconds - 0.05, 60.0 / bpm)):
        s = int(start * sr)
        click = (0.8 if i % 4 == 0 else 0.4) * np.exp(-t / 0.005) * np.sin(
            2 * np.pi * (1760 if i % 4 == 0 else 880) * t)
        wave[s:s + n] += click[:len(wave) - s]
    save_wav(path, wave, sr)
    return path


def _settings(tmp_path, side):
    """The same small settings for both packages: 64-frame segments two at
    a time, a tiny decoder, the committed checkpoints."""
    ckpt = tmp_path / "decoder"
    if not ckpt.exists():
        ckpt.mkdir()
        vocab = _build_vocab()
        vocab.save(ckpt / "vocab.json")
        JaxDecoderConfig(vocab_size=len(vocab), hidden_size=32, num_hidden_layers=2,
                         num_attention_heads=4, intermediate_size=64,
                         max_position_embeddings=256, attribute_emb_dim=8,
                         ).to_json_file(ckpt / "etude_decoder_config.json")
    settings = {
        "paths": {
            "infer_output_dir": str(tmp_path / side),
            "extractor_model": str(REPO / "checkpoints/extractor/latest.ckpt"),
            "separator_model": str(REPO / "checkpoints/separator/latest.ckpt"),
            "beat_detector_model": str(REPO / "checkpoints/beat_detector/latest.ckpt"),
            "decoder_vocab": str(ckpt / "vocab.json"),
            "decoder_config": str(ckpt / "etude_decoder_config.json"),
            "decoder_model": str(ckpt / "latest.ckpt"),
        },
        "extractor": {"input": {"num_frame": 64}, "infer": {"segment_batch": 2}},
        "decoder": {"max_bar_token_limit": 16},
    }
    path = tmp_path / f"{side}.json"
    path.write_text(json.dumps(settings))
    return path


def test_input_pipeline_matches_jax(tmp_path, monkeypatch, committed_params,  # noqa: F811
                                    jax_f32_extractor, jax_f32_separator,  # noqa: F811
                                    jax_f32_detector):  # noqa: F811
    wav = _song(tmp_path / "song.wav")

    # JAX: the root CLI's pipeline (yaml settings are a superset of json).
    jax_cfg = jax_load_config(str(_settings(tmp_path, "jax")))
    JaxInferencePipeline(jax_cfg, allow_random_weights=True).run(str(wav), ATTRS)
    jax_work = tmp_path / "jax" / "temp"

    # The port's CLI, with the committed trees handed to its loader (the
    # orbax files themselves are not readable there).
    trees = {"extractor": committed_params, "separator": _committed("separator"),
             "beat model": _committed("beat")}
    load = model_loader.load_params
    monkeypatch.setattr(model_loader, "load_params",
                        lambda what, *a, **kw: trees[what] if what in trees else load(what, *a, **kw))
    spans = {}
    monkeypatch.setattr(StageTimer, "print_summary",
                        lambda self, title="": spans.update(self.summary()))
    rc = infer.main(["--config", str(_settings(tmp_path, "port")), "--input", str(wav),
                     "--device", "cpu", "--allow-random-weights"])
    assert rc == 0
    work = tmp_path / "port" / "temp"

    assert (work / "origin.wav").read_bytes() == wav.read_bytes()
    loaded = {name: json.loads((work / name).read_text()) for name in OUTPUTS}
    want = {name: json.loads((jax_work / name).read_text()) for name in OUTPUTS}
    assert want["extract.json"] and want["tempo.json"], "the song should give notes and a grid"
    assert loaded["tempo.json"] == want["tempo.json"]
    assert loaded["beat_pred.json"] == want["beat_pred.json"]
    np.testing.assert_allclose(loaded["volume.json"], want["volume.json"], atol=1e-6, rtol=0)
    got_notes, want_notes = loaded["extract.json"], want["extract.json"]
    assert len(got_notes) == len(want_notes)
    for a, b in zip(got_notes, want_notes):
        assert (a["pitch"], a["velocity"]) == (b["pitch"], b["velocity"])
        assert a["onset"] == pytest.approx(b["onset"], abs=TIME_ATOL)
        assert a["offset"] == pytest.approx(b["offset"], abs=TIME_ATOL)
    midi = tmp_path / "port" / "output.mid"
    assert midi.exists() and isinstance(read_midi_notes(midi), list)
    assert {"audio decode", "stage1+2_concurrent", "stage1_extract", "stage2_structuralize",
            "extract: resample", "extract: wav→mel", "extract: hFT forward",
            "extract: peak picking", "extract: volume analysis", "stage3_decode",
            "decode: generate"} <= set(spans)


def test_input_without_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wav = _song(tmp_path / "song.wav", seconds=1.0)
    with pytest.raises(RuntimeError, match="--device cpu"):
        infer.main(["--config", str(_settings(tmp_path, "port")), "--input", str(wav),
                    "--allow-random-weights"])
    assert not (tmp_path / "port" / "temp" / "extract.json").exists()


def test_url_input_is_fetched_by_yt_dlp(tmp_path, monkeypatch):
    """A URL goes through yt-dlp (here chip_smoke.py's stand-in, which copies
    a local file) into the work dir's origin.wav; without yt-dlp, or for a
    path that is no file, the run exits 1."""
    import chip_smoke

    pipeline = infer.InferencePipeline(load_config(_settings(tmp_path, "port")), device="cpu",
                                       allow_random_weights=True)
    wav = _song(tmp_path / "song.wav", seconds=1.0)
    url = "https://example.invalid/song.mp3"
    log = chip_smoke.ytdlp_stub(tmp_path / "bin", {url: wav})
    monkeypatch.setenv("PATH", str(log.parent))
    assert pipeline._prepare_audio(url).read_bytes() == wav.read_bytes()
    assert len(chip_smoke.stub_calls(log)) == 1
    monkeypatch.setenv("PATH", str(tmp_path / "port"))
    for source in (url, str(tmp_path / "missing.wav")):
        with pytest.raises(SystemExit) as exit_:
            pipeline._prepare_audio(source)
        assert exit_.value.code == 1


def test_missing_extractor_weights_need_the_flag(tmp_path):
    config = load_config(_settings(tmp_path, "port"),
                         {"paths": {"extractor_model": str(tmp_path / "none.ckpt")}})
    pipeline = infer.InferencePipeline(config, device="cpu")
    with pytest.raises(SystemExit):
        pipeline._require_weights("extract")
    with pytest.raises(SystemExit):
        pipeline.run(str(_song(tmp_path / "song.wav", seconds=1.0)), ATTRS)
    assert not (pipeline.work_dir / "origin.wav").exists()


def test_timer_keeps_every_span_of_concurrent_stages():
    """The pipeline's stage threads record into one StageTimer: with more
    threads than cores and a short switch interval, no span is lost."""
    timer = StageTimer(torch.device("cpu"))

    def stage(i):
        for j in range(200):
            with timer.span(f"{i}.{j}", nested=bool(j % 2)):
                pass

    interval = sys.getswitchinterval()
    try:
        sys.setswitchinterval(1e-6)
        with ThreadPoolExecutor(32) as pool:
            for future in [pool.submit(stage, i) for i in range(32)]:
                future.result(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert len(timer.spans) == len(timer.summary()) == 32 * 200
    assert sum(s["nested"] for s in timer.spans) == 32 * 100


def test_trace_dir_writes_a_profiler_trace(tmp_path, monkeypatch):
    """`ETUDE_TRACE_DIR` turns on a torch.profiler trace of the run; with
    neither it nor an argument, `trace()` records nothing."""
    with trace():
        torch.ones(4).sum()
    assert not list(tmp_path.iterdir())
    monkeypatch.setenv("ETUDE_TRACE_DIR", str(tmp_path / "trace"))
    with trace():
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
