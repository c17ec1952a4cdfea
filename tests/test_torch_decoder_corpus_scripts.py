"""The port's full-pipeline and WPD corpus scripts
(etude_tpu_torch/scripts/{eval_full_pipeline,validate_wpd_audio_path,
diagnose_wpd_outliers}.py) against the JAX scripts (scripts/*.py, imported
through `sys.path`) on the CPU, on a synthetic corpus
(etude_tpu_torch/tools/synthetic_corpus.py), and the refusals every
decoder-corpus script shares.

Tolerances:
- validate_wpd_audio_path, diagnose_wpd_outliers: the aligner's warping
  paths are equal between the packages (tests/test_torch_align.py holds
  them bit for bit), so the rows are equal but for the wall-clock fields;
  `mapping_on_grid` and `compare_paths` are numpy and bit-equal.
- eval_full_pipeline: random extractor and decoder weights at narrow
  widths, the committed separator and beat model (a random beat model finds
  no stable tempo region, and without a grid there is nothing to decode);
  the output has the JAX script's keys and a MIDI that parses.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from etude_tpu_torch.data.vocab import Vocab
from etude_tpu_torch.models.decoder import EtudeDecoderConfig
from etude_tpu_torch.scripts import (
    diagnose_wpd_outliers, distill_dataset, eval_distilled, eval_engine_parity,
    eval_full_pipeline, sweep_sampling, validate_wpd_audio_path,
)
from etude_tpu_torch.tools.synthetic_corpus import write_corpus
from etude_tpu_torch.utils import model_loader
from etude_tpu_torch.utils.midi import read_midi_notes

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import diagnose_wpd_outliers as jax_diagnose  # noqa: E402
import validate_wpd_audio_path as jax_validate  # noqa: E402

WALL_KEYS = {"align_seconds", "render_seconds"}
# scripts/eval_full_pipeline.py's summary and row keys (with --versions
# human etude_d).
FULL_KEYS = {"songs", "song_seconds", "engine", "mean_wall_s", "rgc", "ipe", "rows"}
FULL_ROW_KEYS = {"song", "wall_s", "rgc_ours", "ipe_ours", "n_notes", "rgc_human",
                 "ipe_human", "rgc_etude_d", "ipe_etude_d"}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("songs")
    write_corpus(root, n_songs=2, seconds=(16.0, 17.0), seed=0)
    return root


def _without_walls(rows):
    return [{k: v for k, v in r.items() if k not in WALL_KEYS} for r in rows]


# ------------------------------------------------------ WPD
def test_mapping_and_compare_paths_equal_jax():
    rng = np.random.default_rng(0)
    for n in (40, 400):
        a = np.stack([np.sort(rng.integers(0, 5 * n, n)), np.sort(rng.integers(0, 5 * n, n))])
        b = np.stack([np.sort(rng.integers(0, 5 * n, n)), np.sort(rng.integers(0, 5 * n, n))])
        grid = np.arange(0.0, a[0].max() / 50, 0.37)
        np.testing.assert_array_equal(diagnose_wpd_outliers.mapping_on_grid(a, grid),
                                      jax_diagnose.mapping_on_grid(a, grid))
        assert diagnose_wpd_outliers.compare_paths(a, b) == jax_diagnose.compare_paths(a, b)
        assert diagnose_wpd_outliers.compare_paths(a, a)["frac_off_gt1s"] == 0.0
    short = np.stack([np.arange(100), np.arange(100)])
    assert diagnose_wpd_outliers.compare_paths(short, short) == {
        "error": "paths too short to compare"}


def test_validate_wpd_audio_path_equals_jax(corpus, capsys, monkeypatch):
    argv = ["--songs", "2", "--seconds", "8"]
    assert validate_wpd_audio_path.main([*argv, "--corpus", str(corpus),
                                         "--device", "cpu"]) == 0
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    songs = jax_validate.corpus_song_dirs
    monkeypatch.setattr(jax_validate, "corpus_song_dirs", lambda root=corpus: songs(root))
    assert jax_validate.main(argv) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(ours) == set(ref) == {"songs", "mean_abs_delta", "max_abs_delta"}
    assert [r["song"] for r in ours["songs"]] == ["CPOP01", "CPOP02"]
    assert _without_walls(ours["songs"]) == _without_walls(ref["songs"])
    assert {k: ours[k] for k in ("mean_abs_delta", "max_abs_delta")} == {
        k: ref[k] for k in ("mean_abs_delta", "max_abs_delta")}
    for row in ours["songs"]:
        assert row["wpd_cached"] == 0.0 and row["wpd_audio_path"] is not None


def test_diagnose_wpd_outliers_equals_jax(tmp_path, corpus, capsys, monkeypatch):
    argv = ["--songs", "CPOP02", "--ablate-song", "CPOP02"]
    assert diagnose_wpd_outliers.main([*argv, "--corpus", str(corpus), "--device", "cpu",
                                       "--out", str(tmp_path / "port.json")]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setattr(jax_diagnose, "CORPUS", corpus)
    assert jax_diagnose.main([*argv, "--out", str(tmp_path / "jax.json")]) == 0
    ours = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "jax.json").read_text())
    assert ours == printed
    assert set(ours["ablations"]) == {"alpha=0.2", "alpha=0.8", "no_tuning"}
    for proxies in (ours["songs"]["CPOP02"]["proxies"], ref["songs"]["CPOP02"]["proxies"]):
        for row in proxies.values():
            row.pop("align_seconds")
    assert ours == ref
    assert ours["songs"]["CPOP02"]["wpd_cached"] == 0.0


# ------------------------------------------------------ eval_full_pipeline
def test_eval_full_pipeline_random_weights(tmp_path, corpus, capsys, monkeypatch):
    from test_torch_structuralize import _committed

    trees = {"separator": _committed("separator"), "beat model": _committed("beat")}
    load = model_loader.load_params
    monkeypatch.setattr(model_loader, "load_params", lambda what, *a, **kw: (
        trees[what] if what in trees else load(what, *a, **kw)))
    vocab_path = REPO / "checkpoints" / "decoder" / "vocab.json"
    EtudeDecoderConfig(vocab_size=len(Vocab.load(vocab_path)), hidden_size=32,
                       num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
                       max_position_embeddings=256, attribute_emb_dim=8,
                       ).to_json_file(tmp_path / "decoder.json")
    missing = str(tmp_path / "none")
    settings = tmp_path / "settings.json"
    settings.write_text(json.dumps({
        "paths": {"extractor_model": missing, "separator_model": missing,
                  "beat_detector_model": missing, "decoder_model": missing,
                  "decoder_vocab": str(vocab_path),
                  "decoder_config": str(tmp_path / "decoder.json")},
        "extractor": {"input": {"num_frame": 64}, "infer": {"segment_batch": 2},
                      "model": {"transformer_hid_dim": 32, "transformer_pf_dim": 64,
                                "encoder_n_layer": 1, "decoder_n_layer": 1}},
        "decoder": {"max_bar_token_limit": 16}}))
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        rc = eval_full_pipeline.main([
            "--songs", "1", "--seconds", "15", "--corpus", str(corpus), "--config",
            str(settings), "--allow-random-weights", "--device", "cpu",
            "--versions", "human", "etude_d", "--out", str(tmp_path / "out")])
    finally:
        torch.set_num_threads(n)
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(summary) == FULL_KEYS
    assert set(summary["rgc"]) == set(summary["ipe"]) == {"ours", "human", "etude_d"}
    row, = summary["rows"]
    assert set(row) == FULL_ROW_KEYS and row["song"] == "CPOP01" and row["wall_s"] > 0
    notes = read_midi_notes(tmp_path / "out" / "CPOP01" / "out" / "ours.mid")
    assert len(notes) == row["n_notes"]
    assert summary["songs"] == 1 and summary["engine"] == "stream"


# ------------------------------------------------------ refusals and devices
def _scripts(tmp):
    """(module, argv without --device, output flags) per script."""
    run = ["--run", str(tmp), "--vocab", str(tmp / "vocab.json")]
    return {
        "distill_dataset": (distill_dataset.main, ["--corpus", str(tmp)], ["--out"]),
        "eval_distilled": (eval_distilled.main, run, ["--out"]),
        "eval_engine_parity": (eval_engine_parity.main, run, ["--out"]),
        "sweep_sampling": (sweep_sampling.main, ["--corpus", str(tmp)], ["--out", "--cache"]),
        "eval_full_pipeline": (eval_full_pipeline.main, ["--corpus", str(tmp)], ["--out"]),
        "validate_wpd_audio_path": (validate_wpd_audio_path.main, ["--corpus", str(tmp)], []),
        "diagnose_wpd_outliers": (diagnose_wpd_outliers.main, ["--corpus", str(tmp)],
                                  ["--out"]),
    }


SCRIPTS = ("distill_dataset", "eval_distilled", "eval_engine_parity", "sweep_sampling",
           "eval_full_pipeline", "validate_wpd_audio_path", "diagnose_wpd_outliers")


@pytest.mark.parametrize("name", SCRIPTS)
def test_scripts_run_on_the_card_by_default(tmp_path, name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, argv, _ = _scripts(tmp_path)[name]
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(argv)


@pytest.mark.parametrize("committed", ["dataset_distill", "validation", "checkpoints"])
@pytest.mark.parametrize("name", [n for n in SCRIPTS if n != "validate_wpd_audio_path"])
def test_scripts_refuse_the_jax_packages_directories(tmp_path, name, committed):
    main, argv, flags = _scripts(tmp_path)[name]
    for flag in flags:
        with pytest.raises(ValueError, match=f"under {committed}/"):
            main([*argv, flag, str(REPO / committed / "x"), "--device", "cpu"])
    assert not (REPO / committed / "x").exists()


def test_default_outputs_lie_outside_the_jax_packages_directories():
    import tempfile

    from etude_tpu_torch.scripts import COMMITTED, OUTPUTS, refuse_committed

    defaults = [OUTPUTS / "distill_dataset", OUTPUTS / "sampling_sweep.json",
                OUTPUTS / "wpd_outliers.json", eval_distilled.DEFAULT_OUT,
                eval_engine_parity.DEFAULT_OUT, sweep_sampling.DEFAULT_CACHE,
                eval_full_pipeline.DEFAULT_OUT]
    for path in defaults:
        assert refuse_committed(path, "--out") == path.resolve()
    for path in (eval_distilled.DEFAULT_OUT, sweep_sampling.DEFAULT_CACHE,
                 eval_full_pipeline.DEFAULT_OUT, eval_engine_parity.DEFAULT_OUT):
        assert path.parent == Path(tempfile.gettempdir()) and "torch" in path.name
    assert COMMITTED == ("checkpoints", "dataset_distill", "validation")
