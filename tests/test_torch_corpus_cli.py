"""The corpus scripts of the port as command lines (`python -m
etude_tpu_torch.scripts.<name>`), on the CPU, on a synthetic corpus
(etude_tpu_torch/tools/synthetic_corpus.py), with the separator and the
Beat-Transformer at narrow widths read from params-only exports through
their `--separator-model` / `--beat-model` flags: validate_beat_corpus,
gen_beat_scenes, gen_pseudopop_scenes (both stages),
gen_pseudopop_sep_examples and eval_separator_pseudopop. Their files have
the JAX scripts' keys, shapes and dtypes; the two numpy-only outputs (the
raw pseudo-pop scenes and the separator rows) are bit-equal to the JAX
scripts' own, run with the same arguments (imported through `sys.path`).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import etude_tpu.data.corpus_render as jax_cr
from etude_tpu_torch.data import beat_detector, corpus_render, separation
from etude_tpu_torch.models.beat_transformer import BeatTransformerConfig
from etude_tpu_torch.models.separator import SeparatorConfig
from etude_tpu_torch.scripts import (eval_separator_pseudopop, gen_beat_scenes,
                                     gen_pseudopop_scenes, gen_pseudopop_sep_examples,
                                     validate_beat_corpus)
from etude_tpu_torch.tools import synthetic_corpus
from etude_tpu_torch.utils.training import save_aux_params
from etude_tpu_torch.weights import init_beat_params_np, init_separator_params_np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import gen_pseudopop_scenes as jax_ppscenes  # noqa: E402
import gen_pseudopop_sep_examples as jax_sep_examples  # noqa: E402

SEPARATOR = SeparatorConfig(base_channels=2, depth=2)
BEAT = BeatTransformerConfig(dmodel=32, nhead=8, d_hid=64, nlayers=3)


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads: these models are narrow, and a CPU shared by
    several test workers loses more to contending threads than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("songs")
    assert synthetic_corpus.main(["--out", str(root), "--songs", "6", "--seconds", "20", "30",
                                  "--seed", "0"]) == 0
    return root


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    root = tmp_path_factory.mktemp("exports")
    save_aux_params(root / "separator" / "latest", init_separator_params_np(SEPARATOR, seed=1))
    save_aux_params(root / "beat_detector" / "latest", init_beat_params_np(BEAT, seed=2))
    return root


@pytest.fixture
def narrow(monkeypatch, corpus, exports):
    """The scripts' models at the narrow widths of the exports, the
    corpus at CORPUS_ROOT; the model flags and the device for argv."""
    monkeypatch.setattr(separation, "SeparatorConfig", lambda: SEPARATOR)
    monkeypatch.setattr(beat_detector, "beat_model_config_from", lambda config: BEAT)
    monkeypatch.setattr(corpus_render, "CORPUS_ROOT", corpus)
    return ["--separator-model", str(exports / "separator" / "latest"), "--device", "cpu"]


def _beat_flag(exports):
    return ["--beat-model", str(exports / "beat_detector" / "latest")]


@pytest.mark.parametrize("extra", [[], ["--no-separator", "--octave-disambiguation"]],
                         ids=["separated", "bypass-octave"])
def test_validate_beat_corpus(corpus, exports, narrow, extra, capsys):
    assert validate_beat_corpus.main(["--corpus", str(corpus), "--songs", "2", "--seconds",
                                      "30", "--held-out-only", *narrow, *_beat_flag(exports),
                                      *extra]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(summary) == {"songs", "snap_gated_out", "mean_beat_f", "mean_beat_f_octave"}
    assert [r["song"] for r in summary["songs"]] == ["CPOP01", "CPOP04"]
    for row in summary["songs"]:
        assert set(row) == {"beat_f", "beat_f_octave", "n_est", "n_ref", "song", "snap_dev_s"}
        assert 0.0 <= row["beat_f"] <= row["beat_f_octave"] <= 1.0 and row["n_ref"] >= 8


def test_validate_beat_corpus_runs_on_the_card_by_default(corpus):
    with pytest.raises(RuntimeError, match="--device cpu"):
        validate_beat_corpus.main(["--corpus", str(corpus)])


def test_gen_beat_scenes(tmp_path, corpus, narrow):
    out = tmp_path / "scenes"
    assert gen_beat_scenes.main(["--n-scenes", "3", "--shard-size", "2", "--out", str(out),
                                 "--corpus", str(corpus), *narrow]) == 0
    shards = sorted(out.glob("shard_*.npz"))
    assert [p.name for p in shards] == ["shard_0000.npz", "shard_0001.npz"]
    for shard, n in zip(shards, (2, 1)):
        with np.load(shard) as z:
            assert sorted(z.files) == ["activations", "tempo", "x"]
            assert z["x"].shape == (n, 5, 512, 128) and z["x"].dtype == np.float16
            assert z["activations"].shape == (n, 512, 2)
            assert z["activations"].dtype == np.float16
            assert z["tempo"].shape == (n,) and z["tempo"].dtype == np.int32
            assert np.isfinite(z["x"].astype(np.float32)).all()
            assert z["x"].max() <= 0.0 and z["x"].min() >= -80.0
    meta = json.loads((out / "meta.json").read_text())
    assert meta["n_scenes"] == 3 and meta["shards"] == 2 and meta["pool"] == 12


def test_gen_pseudopop_scenes_both_stages(tmp_path, corpus, narrow, monkeypatch):
    out = tmp_path / "pp"
    render = ["--stage", "render", "--n-scenes", "2", "--corpus", str(corpus)]
    assert gen_pseudopop_scenes.main([*render, "--out", str(out)]) == 0
    songs = jax_cr.corpus_song_dirs
    monkeypatch.setattr(jax_cr, "corpus_song_dirs", lambda root=corpus: songs(root))
    assert jax_ppscenes.main([*render, "--out", str(tmp_path / "jax")]) == 0
    raw = sorted((out / "raw").glob("scene_*.npz"))
    assert [p.name for p in raw] == ["scene_00000.npz", "scene_00001.npz"]
    for path in raw:
        with np.load(path) as a, np.load(tmp_path / "jax" / "raw" / path.name) as b:
            assert a.files == b.files == ["mix_i16", "activations", "tempo"]
            for key in a.files:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert gen_pseudopop_scenes.main(["--stage", "features", "--out", str(out), *narrow]) == 0
    with np.load(out / "shard_0000.npz") as z:
        assert z["x"].shape == (2, 5, 512, 128) and z["x"].dtype == np.float16
        assert z["activations"].shape == (2, 512, 2) and z["tempo"].dtype == np.int32
    meta = json.loads((out / "meta.json").read_text())
    assert meta["domain"] == "pseudo-pop" and meta["n_scenes"] == 2


def test_gen_pseudopop_sep_examples_equal_jax(tmp_path, corpus, monkeypatch):
    monkeypatch.setattr(corpus_render, "CORPUS_ROOT", corpus)
    songs = jax_cr.corpus_song_dirs
    monkeypatch.setattr(jax_cr, "corpus_song_dirs", lambda root=corpus: songs(root))
    for n in ("3", "4"):      # a second run tops the shards up
        argv = ["--n", n, "--shard-size", "2", "--seed", "1"]
        assert gen_pseudopop_sep_examples.main([*argv, "--out", str(tmp_path / "port")]) == 0
        assert jax_sep_examples.main([*argv, "--out", str(tmp_path / "jax")]) == 0
    shards = sorted((tmp_path / "port").glob("shard_*.npz"))
    assert [p.name for p in shards] == ["shard_0000.npz", "shard_0001.npz", "shard_0002.npz"]
    for path in shards:
        with np.load(path) as a, np.load(tmp_path / "jax" / path.name) as b:
            assert a.files == b.files == ["mix_mag", "stem_mags"]
            assert a["mix_mag"].shape[1:] == (256, 2049) and a["mix_mag"].dtype == np.float16
            assert a["stem_mags"].shape[1:] == (5, 256, 2049)
            for key in a.files:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert (json.loads((tmp_path / "port" / "meta.json").read_text())
            == json.loads((tmp_path / "jax" / "meta.json").read_text()))


def test_eval_separator_pseudopop(tmp_path, corpus, exports, narrow, capsys):
    out = tmp_path / "summary.json"
    assert eval_separator_pseudopop.main(["--songs", "1", "--seconds", "10", "--corpus",
                                          str(corpus), "--out", str(out), *narrow,
                                          *_beat_flag(exports)]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary == json.loads(out.read_text())
    assert set(summary) == {"songs", "mean_si_sdr", "mean_si_sdr_mix_baseline",
                            "mean_beat_f_sep", "mean_beat_f_bypass"}
    row, = summary["songs"]
    assert row["song"] == "CPOP01"
    stems = ["vocals", "piano", "guitar", "bass", "drums"]
    assert list(row["si_sdr"]) == list(row["si_sdr_mix_baseline"]) == stems
    assert all(np.isfinite(list(row["si_sdr"].values())))
    assert 0.0 <= row["beat_f_sep"] <= 1.0 and 0.0 <= row["beat_f_bypass"] <= 1.0


@pytest.mark.parametrize("script,argv", [
    (gen_beat_scenes, []),
    (gen_pseudopop_scenes, ["--stage", "render"]),
    (gen_pseudopop_sep_examples, []),
    (eval_separator_pseudopop, []),
], ids=["gen_beat_scenes", "gen_pseudopop_scenes", "gen_pseudopop_sep_examples",
        "eval_separator_pseudopop"])
def test_scripts_refuse_checkpoints(script, argv):
    with pytest.raises(ValueError, match="checkpoints"):
        script.main([*argv, "--out", str(REPO / "checkpoints" / "x")])
