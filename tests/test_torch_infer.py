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
        "decoder": {"max_bar_token_limit": from_yaml.decoder.max_bar_token_limit},
    }))
    assert load_config(settings) == from_yaml
    assert from_yaml.decoder.max_bar_token_limit == 16
    assert infer.main(["--config", str(settings), *ARGS, "--output_name", "j"]) == 0
    assert (tmp_path / "outputs" / "infer" / "j.mid").exists()


def test_sweep_writes_27_files(decode_only_env):  # noqa: F811
    tmp_path, cfg_yaml = decode_only_env
    rc = infer.main(["--config", str(cfg_yaml), *ARGS, "--sweep",
                     "--output_name", "sw", "--temperature", "0.9", "--seed", "1"])
    assert rc == 0
    assert len(list((tmp_path / "outputs" / "infer").glob("sw_p*r*s*.mid"))) == 27


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
def test_unported_options_raise(decode_only_env, extra):  # noqa: F811
    _, cfg_yaml = decode_only_env
    with pytest.raises(NotImplementedError, match="not yet ported"):
        infer.main(["--config", str(cfg_yaml), *ARGS, *extra])


def test_input_pipeline_not_yet_ported():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        infer.main(["--input", "song.wav", "--device", "cpu"])
