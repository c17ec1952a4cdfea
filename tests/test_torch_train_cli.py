"""The whole slice against the JAX package: the root train.py (YAML
settings) and `python -m etude_tpu_torch.train --device cpu` (the same
settings as .json) on three corpus songs at tiny widths, f32, then the port
serving `--decode-only` from its own export.

Tolerances: the metrics.jsonl keys, `step` and `skipped_updates` equal; the
epoch loss (the mean of three step losses) and its rate to 1e-5 relative;
the exported parameters to 1e-6 absolute, except the key biases outside the
rotary dims (zero gradient; see tests/test_torch_train_step.py), held to
twice the sum of the rates applied. The JAX run trains data-parallel over
the 8 virtual CPU devices of tests/conftest.py with layer remat, as its CLI does;
the sums then run in another order.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from etude_tpu.models.decoder import EtudeDecoderConfig as JaxConfig
from etude_tpu.models.decoder import init_params
from etude_tpu.utils.training import load_params_only as jax_load_params_only
from etude_tpu_torch import infer, train
from etude_tpu_torch.utils.midi import read_midi_notes
from etude_tpu_torch.utils.training import load_params_only
from test_torch_dataset import CORPUS, copy_songs
from test_torch_train_step import PARAM_ATOL, TINY, assert_params_close
from train import main as jax_train_main

REPO = Path(__file__).resolve().parent.parent
WIDTHS = {k: v for k, v in TINY.items() if k != "vocab_size"} | {"max_position_embeddings": 128}
TRAIN = {"batch_size": 4, "gradient_accumulation_steps": 2, "max_seq_len": 128,
         "num_epochs": 30, "warmup_epochs": 0.01, "learning_rate": 1e-3,
         "save_every_n_epochs": 1}


def settings(root: Path, out: Path) -> dict:
    return {
        "env": {"compute_dtype": "float32"},
        "paths": {"dataset_vocab": str(CORPUS / "vocab.json"),
                  "tokenized_dir": str(root), "train_output_dir": str(out)},
        "decoder": WIDTHS,
        "train": TRAIN,
    }


def yaml_text(d: dict, indent: int = 0) -> str:
    lines = []
    for key, value in d.items():
        if isinstance(value, dict):
            lines.append(" " * indent + f"{key}:")
            lines.append(yaml_text(value, indent + 2))
        else:
            lines.append(" " * indent + f"{key}: {value}")
    return "\n".join(lines)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_cli")
    data = copy_songs(tmp / "tokenized")
    (tmp / "jax.yaml").write_text(yaml_text(settings(data, tmp / "jax")) + "\n")
    (tmp / "port.json").write_text(json.dumps(settings(data, tmp / "port")))
    common = ["--run-id", "r", "--max-steps", "3"]
    assert jax_train_main(["--config", str(tmp / "jax.yaml"), *common]) == 0
    run = train.run(["--config", str(tmp / "port.json"), "--device", "cpu", *common])
    assert run is not None
    return tmp, run


def read_metrics(path: Path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_metrics_and_export_match_jax(runs):
    tmp, run = runs
    ours = read_metrics(tmp / "port" / "r" / "metrics.jsonl")
    ref = read_metrics(tmp / "jax" / "r" / "metrics.jsonl")
    assert len(ours) == len(ref) == 1
    assert ours[0].keys() == ref[0].keys()
    for key in ("epoch", "step", "skipped_updates"):
        assert ours[0][key] == ref[0][key]
    assert ours[0]["step"] == 3 and ours[0]["skipped_updates"] == 0
    np.testing.assert_allclose(ours[0]["loss"], ref[0]["loss"], rtol=1e-5)
    np.testing.assert_allclose(ours[0]["lr"], ref[0]["lr"], rtol=1e-5)
    assert len(run.losses) == 3 and np.mean(run.losses) == pytest.approx(ours[0]["loss"])

    # The same files beside each run (orbax on the JAX side).
    names = {"metrics.jsonl", "metadata.json", "etude_decoder_config.json", "vocab.json",
             "latest", "epoch_0001", "model"}
    assert {p.name for p in (tmp / "port" / "r").iterdir()} == names
    assert names <= {p.name for p in (tmp / "jax" / "r").iterdir()}
    for name in ("metadata.json", "etude_decoder_config.json", "vocab.json"):
        assert (json.loads((tmp / "port" / "r" / name).read_text())
                == json.loads((tmp / "jax" / "r" / name).read_text()))

    config = JaxConfig.from_json_file(tmp / "jax" / "r" / "etude_decoder_config.json")
    ref_params = jax_load_params_only(tmp / "jax" / "r" / "model",
                                      init_params(config, abstract=True), cache=False)
    ours = load_params_only(tmp / "port" / "r" / "model")
    rates = sum(float(train.make_optimizer(1e-3, 1, 3)[1](s)) for s in range(3))
    assert_params_close(ours, jax.device_get(ref_params), 2 * rates)
    assert PARAM_ATOL == 1e-6


def test_port_serves_from_its_own_export(runs, tmp_path):
    tmp, _ = runs
    run_dir = tmp / "port" / "r"
    work = tmp_path / "outputs" / "infer" / "temp"
    work.mkdir(parents=True)
    (work / "tempo.json").write_text(json.dumps([{
        "time_sig": 4, "bpm": 120.0, "start": 1.0,
        "downbeats": [1.0 + 2.0 * i for i in range(4)]}]))
    (work / "extract.json").write_text(json.dumps([
        {"onset": 1.0 + 0.5 * i, "offset": 1.4 + 0.5 * i, "pitch": 60 + i % 12,
         "velocity": 80} for i in range(12)]))
    (work / "volume.json").write_text(json.dumps([0.5] * 300))
    serve = tmp_path / "serve.json"
    serve.write_text(json.dumps({
        "paths": {"infer_output_dir": str(tmp_path / "outputs" / "infer"),
                  "decoder_model": str(run_dir / "model"),
                  "decoder_config": str(run_dir / "etude_decoder_config.json"),
                  "decoder_vocab": str(run_dir / "vocab.json")},
        "decoder": {"max_bar_token_limit": 16},
    }))
    rc = infer.main(["--config", str(serve), "--decode-only", "--device", "cpu",
                     "--output_name", "trained", "--seed", "3"])
    assert rc == 0
    midi = tmp_path / "outputs" / "infer" / "trained.mid"
    assert midi.exists()
    read_midi_notes(midi)


def test_train_without_gpu_raises_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device resolves")
    settings = tmp_path / "defaults.json"
    settings.write_text("{}")
    proc = subprocess.run(
        [sys.executable, "-m", "etude_tpu_torch.train", "--config", str(settings)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr


def test_settings_keep_the_declared_type(tmp_path):
    """A fractional value of a float field with an integral default (JAX
    schema: `warmup_epochs: float = 10`) stays fractional."""
    from etude_tpu_torch.config import load_config

    path = tmp_path / "s.json"
    path.write_text(json.dumps({"train": {"warmup_epochs": 0.25, "num_epochs": 3},
                                "decoder": {"hidden_size": 64}}))
    cfg = load_config(path)
    assert cfg.train.warmup_epochs == 0.25 and isinstance(cfg.train.num_epochs, int)
    assert cfg.decoder.hidden_size == 64 and cfg.train.init_from is None
