"""The port's decode-only CLI (etude_tpu_torch/infer.py) on the work-dir
fixture of tests/test_infer_pipeline.py, on the CPU."""

import json

import pytest
import torch

from etude_tpu_torch import infer
from etude_tpu_torch.config import load_config
from etude_tpu_torch.utils.midi import read_midi_notes
from infer import main as jax_infer_main
from test_infer_pipeline import decode_only_env  # noqa: F401  (fixture)

ARGS = ["--decode-only", "--device", "cpu", "--allow-random-weights"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny-width tests run one small op after another: with pytest's
    workers sharing the cores, torch's thread pool only contends. One
    thread, restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_decode_only_cpu_writes_parsing_midi(decode_only_env):  # noqa: F811
    tmp_path, cfg_yaml = decode_only_env
    rc = infer.main(["--config", str(cfg_yaml), *ARGS, "--output_name", "song",
                     "--polyphony", "2", "--temperature", "0.5", "--seed", "3"])
    assert rc == 0
    out = tmp_path / "outputs" / "infer" / "song.mid"
    assert out.exists()
    for n in read_midi_notes(out):
        assert -1.5 <= n["onset"] <= 12.0


def test_json_settings_file_works_like_yaml(decode_only_env):  # noqa: F811
    tmp_path, cfg_yaml = decode_only_env
    from_yaml = load_config(cfg_yaml)
    settings = tmp_path / "settings.json"
    settings.write_text(json.dumps({
        "paths": {k: str(getattr(from_yaml.paths, k)) for k in
                  ("infer_output_dir", "decoder_vocab", "decoder_config", "decoder_model")},
        "decoder": {"max_bar_token_limit": from_yaml.decoder.max_bar_token_limit,
                    "prompt_buckets": from_yaml.decoder.prompt_buckets},
    }))
    assert load_config(settings) == from_yaml
    assert from_yaml.decoder.max_bar_token_limit == 16
    assert from_yaml.decoder.prompt_buckets == [64, 128, 240]
    assert infer.main(["--config", str(settings), *ARGS, "--output_name", "j"]) == 0
    assert (tmp_path / "outputs" / "infer" / "j.mid").exists()


def test_sweep_writes_27_files(decode_only_env):  # noqa: F811
    tmp_path, cfg_yaml = decode_only_env
    rc = infer.main(["--config", str(cfg_yaml), *ARGS, "--sweep",
                     "--output_name", "sw", "--temperature", "0.9", "--seed", "1"])
    assert rc == 0
    assert len(list((tmp_path / "outputs" / "infer").glob("sw_p*r*s*.mid"))) == 27


def test_sweep_batches_on_one_device(decode_only_env, monkeypatch):  # noqa: F811
    """The sweep's 27 streams go to the engine as one batch, with no
    devices to spread over (the spread is slower while a step is eager
    launches from one interpreter)."""
    from etude_tpu_torch.models.generate_stream import StreamingGenerationEngine

    seen = []
    generate_batch = StreamingGenerationEngine.generate_batch

    def spy(self, model, bars, attrs, **kw):
        seen.append((len(bars), kw.get("devices")))
        return generate_batch(self, model, bars, attrs, **kw)

    monkeypatch.setattr(StreamingGenerationEngine, "generate_batch", spy)
    tmp_path, cfg_yaml = decode_only_env
    assert infer.main(["--config", str(cfg_yaml), *ARGS, "--sweep", "--output_name", "one"]) == 0
    assert seen == [(27, None)]


def test_sweep_of_empty_streams_writes_the_jax_packages_files(decode_only_env):  # noqa: F811
    """With max_output_tokens 0 every stream is empty; the JAX package's
    sweep still writes one .mid per combo, and so must the port's."""
    tmp_path, cfg_yaml = decode_only_env
    cfg_yaml.write_text(cfg_yaml.read_text().replace(
        "decoder:\n", "decoder:\n  max_output_tokens: 0\n"))
    out_dir = tmp_path / "outputs" / "infer"
    sweep = ["--config", str(cfg_yaml), "--decode-only", "--allow-random-weights",
             "--sweep", "--seed", "1"]
    assert jax_infer_main([*sweep, "--output_name", "jax"]) == 0
    assert infer.main([*sweep, "--device", "cpu", "--output_name", "port"]) == 0
    jax_names = sorted(p.name[len("jax"):] for p in out_dir.glob("jax_*.mid"))
    port_names = sorted(p.name[len("port"):] for p in out_dir.glob("port_*.mid"))
    assert len(jax_names) == 27
    assert port_names == jax_names
    for path in out_dir.glob("port_*.mid"):
        assert read_midi_notes(path) == []


def test_no_gpu_without_cpu_request_raises(decode_only_env, monkeypatch):  # noqa: F811
    tmp_path, cfg_yaml = decode_only_env
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        infer.main(["--config", str(cfg_yaml), "--decode-only",
                    "--allow-random-weights"])
    assert not (tmp_path / "outputs" / "infer" / "output.mid").exists()


def test_missing_weights_without_flag_exits(decode_only_env):  # noqa: F811
    _, cfg_yaml = decode_only_env
    with pytest.raises(SystemExit):
        infer.main(["--config", str(cfg_yaml), "--decode-only", "--device", "cpu"])


def test_orbax_checkpoint_raises_naming_the_export(decode_only_env, tmp_path):  # noqa: F811
    root, cfg_yaml = decode_only_env
    orbax_dir = root / "checkpoints" / "decoder" / "latest.ckpt"
    orbax_dir.mkdir()
    with pytest.raises(RuntimeError, match="orbax"):
        infer.main(["--config", str(cfg_yaml), *ARGS])


def test_missing_intermediates_exit(tmp_path):
    settings = tmp_path / "c.json"
    settings.write_text(json.dumps({"paths": {"infer_output_dir": str(tmp_path / "o")}}))
    with pytest.raises(SystemExit):
        infer.main(["--config", str(settings), *ARGS])


@pytest.mark.parametrize("extra", [["--engine", "rebuild"], ["--attrs-prior"]])
def test_options_run_and_a_url_needs_yt_dlp(decode_only_env, monkeypatch, extra):  # noqa: F811
    """These options are ported and run; with them, a URL input without
    yt-dlp on PATH exits 1 and writes no MIDI, as in the JAX package
    (tests/test_torch_download.py fetches one through a stand-in)."""
    tmp_path, cfg_yaml = decode_only_env
    assert infer.main(["--config", str(cfg_yaml), *ARGS, *extra, "--output_name", "o"]) == 0
    assert (tmp_path / "outputs" / "infer" / "o.mid").exists()
    (tmp_path / "empty").mkdir()
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(SystemExit) as exit_:
        infer.main(["--config", str(cfg_yaml), "--input", "https://example.invalid/song.mp3",
                    "--device", "cpu", "--allow-random-weights", *extra, "--output_name", "u"])
    assert exit_.value.code == 1
    assert not (tmp_path / "outputs" / "infer" / "u.mid").exists()


def _spy_on_generate(monkeypatch, engine_classes, seen, key):
    """Records each `generate` call's engine kind, per-bar attributes and
    returned bars."""
    for kind, cls in zip(("rebuild", "stream"), engine_classes):
        def spy(self, model, bars, attrs, _real=cls.generate, _kind=kind, **kw):
            out = _real(self, model, bars, attrs, **kw)
            seen[key] = (_kind, attrs, out)
            return out
        monkeypatch.setattr(cls, "generate", spy)


@pytest.mark.parametrize("extra", [["--engine", "rebuild"], ["--attrs-prior"],
                                   ["--engine", "rebuild", "--attrs-prior"]],
                         ids=["rebuild", "attrs-prior", "both"])
def test_options_through_both_clis_on_one_work_dir(decode_only_env, monkeypatch,  # noqa: F811
                                                   extra):
    """Both packages' `--decode-only` with the option on one work dir: the
    same engine kind gets the same condition bars' count and the same
    per-bar attributes, and returns well-formed bars. (The tokens are held
    against the JAX engines by tests/test_torch_generate.py under the
    near-tie rule; at this fixture's init scale, std 0.02 at width 32, the
    greedy margins are mostly near-ties.)"""
    from etude_tpu.models.generate import GenerationEngine as JaxRebuild
    from etude_tpu.models.generate_stream import StreamingGenerationEngine as JaxStream
    from etude_tpu_torch.models.generate import GenerationEngine
    from etude_tpu_torch.models.generate_stream import StreamingGenerationEngine

    tmp_path, cfg_yaml = decode_only_env
    seen = {}
    _spy_on_generate(monkeypatch, (JaxRebuild, JaxStream), seen, "jax")
    _spy_on_generate(monkeypatch, (GenerationEngine, StreamingGenerationEngine), seen, "port")
    common = ["--config", str(cfg_yaml), "--decode-only", "--allow-random-weights",
              "--seed", "2", "--polyphony", "0", *extra]
    assert jax_infer_main([*common, "--output_name", "jax"]) == 0
    assert infer.main([*common, "--device", "cpu", "--output_name", "port"]) == 0
    kind, attrs, bars = seen["port"]
    assert kind == seen["jax"][0] == ("rebuild" if "rebuild" in extra else "stream")
    assert attrs == seen["jax"][1]
    if "--attrs-prior" not in extra:
        assert all(a["polyphony_bin"] == 0 for a in attrs)
    assert len(bars) == len(seen["jax"][2]) == len(attrs)
    for bar in bars:
        assert bar[0] == 4 and 1 < len(bar) <= 17  # Bar_BOS, then at most 16 tokens
    assert (tmp_path / "outputs" / "infer" / "port.mid").exists()


def test_attrs_prior_conditions_per_bar(decode_only_env, monkeypatch):  # noqa: F811
    """`--attrs-prior` hands the engine the predictor's per-bar bins, not the
    constant combo of --polyphony/--rhythm/--sustain."""
    from etude_tpu_torch.models.attr_prior import AttrPrior
    from etude_tpu_torch.models.generate import GenerationEngine

    _, cfg_yaml = decode_only_env
    seen = {}
    real = GenerationEngine.generate

    def spy(self, model, bars, attrs, **kw):
        seen["bars"], seen["attrs"] = bars, attrs
        return real(self, model, bars, attrs, **kw)

    monkeypatch.setattr(GenerationEngine, "generate", spy)
    assert infer.main(["--config", str(cfg_yaml), *ARGS, "--engine", "rebuild",
                       "--attrs-prior", "--seed", "4"]) == 0
    config = load_config(cfg_yaml)
    from etude_tpu_torch.data.vocab import Vocab

    want = AttrPrior.load(config.paths.checkpoints_dir / "attr_prior").predict_bins(
        seen["bars"], Vocab.load(config.paths.decoder_vocab), seed=4)
    assert seen["attrs"] == want


def test_url_input_without_yt_dlp_exits_1(tmp_path, monkeypatch):
    """`--input` runs the whole pipeline (tests/test_torch_pipeline.py); a
    URL is fetched by yt-dlp (tests/test_torch_download.py), and without it
    on PATH the run exits 1 before the work dir holds any audio."""
    settings = tmp_path / "settings.json"
    settings.write_text(json.dumps({"paths": {"infer_output_dir": str(tmp_path / "out")}}))
    (tmp_path / "empty").mkdir()
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(SystemExit) as exit_:
        infer.main(["--config", str(settings), "--input", "https://example.invalid/song.mp3",
                    "--device", "cpu", "--allow-random-weights"])
    assert exit_.value.code == 1
    assert not (tmp_path / "out" / "temp" / "origin.wav").exists()
