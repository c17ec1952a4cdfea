"""The decoder's evaluation scripts of the port against the JAX package's,
on the CPU, on a synthetic corpus (etude_tpu_torch/tools/synthetic_corpus.py)
and its `distill_dataset --grid rgc` output, with one tiny decoder (init
std 0.1) exported by each package: the rebuild engine's
`forced_history_y`, scripts/eval_distilled.py, eval_engine_parity.py and
sweep_sampling.py (imported through `sys.path`).

Tolerances: both engines decode greedily in bf16 (f32 softmax and LM head),
so a greedy token may flip only at a near-tie: where tokens differ, the
JAX logits' top-2 margin at the first divergence must be under TIE_MARGIN
(tests/test_torch_generate.py). Where these tests compare covers, they are
equal (measured). Sampled configs are compared on keys and counts only
(threefry and Philox differ). Metrics of equal notes are equal.
"""

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from etude_tpu.models import decoder as jdec
from etude_tpu.models import generate as jgen
from etude_tpu.utils import training as jax_training
from etude_tpu_torch import train
from etude_tpu_torch.data.vocab import Vocab
from etude_tpu_torch.models import generate as tgen
from etude_tpu_torch.scripts import (
    distill_dataset, eval_distilled, eval_engine_parity, sweep_sampling,
)
from etude_tpu_torch.tools.synthetic_corpus import write_corpus
from etude_tpu_torch.utils.audio import analyze_volume, save_volume_map, save_wav
from etude_tpu_torch.utils.midi import read_midi_notes
from etude_tpu_torch.utils.training import load_params_only
from test_torch_generate import (
    ENGINE_KW, TIE_MARGIN, _jax_bar_logits, _song, setup,  # noqa: F401  (fixture)
)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import eval_distilled as jax_eval  # noqa: E402
import eval_engine_parity as jax_parity  # noqa: E402
import sweep_sampling as jax_sweep  # noqa: E402

PARITY_KEYS = {"songs", "mean_cross_f1", "mean_rgc_rebuild", "mean_rgc_stream",
               "mean_ipe_rebuild", "mean_ipe_stream", "temperature", "seed", "rows"}
PARITY_ROW_KEYS = {"song", "notes_rebuild", "notes_stream", "cross_f1", "rgc_rebuild",
                   "rgc_stream", "ipe_rebuild", "ipe_stream"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny decoders, one small op after another: one thread is fastest on
    a shared CPU. Restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------ forced_history_y
def _bars_equal_up_to_ties(ours, ref, jconfig, params, jengine, bars, attrs, history_y):
    """Every bar equal, or first differing at a near-tie of the JAX logits
    (the history of bar i is `history_y`'s, as the engines were given)."""
    assert len(ours) == len(ref)
    for i, (a, b) in enumerate(zip(ours, ref)):
        if a == b:
            continue
        step = next((t for t, (x, y) in enumerate(zip(a[1:], b[1:])) if x != y),
                    min(len(a), len(b)) - 1)
        n_ctx = jconfig.context_num_past_xy_pairs
        history = [(bars[j], history_y[j], attrs[j]) for j in range(max(0, i - n_ctx), i)]
        prompt = jengine.build_prompt(history, bars[i], attrs[i])
        logits = _jax_bar_logits(jconfig, params, jengine, prompt, attrs[i], b[1:])
        top2 = np.sort(logits[step])[-2:]
        assert top2[1] - top2[0] < TIE_MARGIN, (i, step, top2[1] - top2[0])


@pytest.mark.parametrize("seed", [0, 4])
def test_forced_history_matches_jax(setup, seed):  # noqa: F811
    """Greedy, with the history forced to given bars: every bar equals the
    JAX engine's. Without it bar 0 still does. The control: the forced bars
    shifted by one bar change the tokens."""
    jconfig, params, config, model = setup
    bars, attrs = _song(n_bars=6, seed=seed)
    forced, _ = _song(n_bars=6, notes_per_bar=5, seed=seed + 100)
    jengine = jgen.GenerationEngine(jconfig, **ENGINE_KW)
    engine = tgen.GenerationEngine(config, **ENGINE_KW)
    ref = jengine.generate_batch(params, [bars], [attrs], forced_history_y=[forced])[0]
    ours = engine.generate_batch(model, [bars], [attrs], forced_history_y=[forced])[0]
    _bars_equal_up_to_ties(ours, ref, jconfig, params, jengine, bars, attrs, forced)

    free = engine.generate_batch(model, [bars], [attrs])[0]
    assert free[0] == jengine.generate_batch(params, [bars], [attrs])[0][0] == ours[0]
    shifted = forced[1:] + forced[:1]
    control = engine.generate_batch(model, [bars], [attrs], forced_history_y=[shifted])[0]
    assert control[0] == ours[0] and control != ref


def test_forced_history_per_stream_and_short(setup):  # noqa: F811
    """Streams of a batch take their own forced bars; a stream whose forced
    bars run out takes its generated bars from there on."""
    _, _, config, model = setup
    engine = tgen.GenerationEngine(config, **ENGINE_KW)
    bars1, attrs1 = _song(n_bars=4, seed=1)
    bars2, attrs2 = _song(n_bars=3, seed=2)
    forced1, _ = _song(n_bars=4, notes_per_bar=5, seed=11)
    forced2, _ = _song(n_bars=1, notes_per_bar=5, seed=12)
    batch = engine.generate_batch(model, [bars1, bars2], [attrs1, attrs2],
                                  forced_history_y=[forced1, forced2])
    assert batch[0] == engine.generate_batch(model, [bars1], [attrs1],
                                             forced_history_y=[forced1])[0]
    assert batch[1] == engine.generate_batch(model, [bars2], [attrs2],
                                             forced_history_y=[forced2])[0]


# ------------------------------------------------------ the scripts
@pytest.fixture(scope="module")
def corpus_env(tmp_path_factory):
    """A 3-song synthetic corpus, its rgc distillation corpus (the port's
    CLI), and a tiny decoder over that vocabulary trained 60 steps on it by
    the port's trainer in f32 (so that its covers hold notes), saved by each
    package (the port: params.npz; JAX: orbax, the same tree)."""
    tmp = tmp_path_factory.mktemp("decoder_corpus")
    songs = tmp / "songs"
    write_corpus(songs, n_songs=3, seconds=(20.0, 22.0), seed=0)
    data = tmp / "distill"
    assert distill_dataset.main(["--corpus", str(songs), "--out", str(data), "--grid", "rgc",
                                 "--device", "cpu"]) == 0
    vocab = Vocab.load(data / "vocab.json")
    settings = tmp / "train.json"
    settings.write_text(json.dumps({
        "paths": {"dataset_vocab": str(data / "vocab.json"),
                  "tokenized_dir": str(data / "tokenized"), "train_output_dir": str(tmp)},
        "decoder": {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
                    "intermediate_size": 64, "attribute_emb_dim": 8,
                    "max_position_embeddings": 640},
        "env": {"compute_dtype": "float32"},
        "train": {"max_seq_len": 256, "batch_size": 4, "gradient_accumulation_steps": 1,
                  "learning_rate": 3e-3, "warmup_epochs": 0.0, "num_epochs": 1000,
                  "save_every_n_epochs": 1000}}))
    assert train.run(["--config", str(settings), "--device", "cpu", "--max-steps", "60",
                      "--run-id", "port_run"]) is not None
    jconfig = jdec.EtudeDecoderConfig.from_json_file(
        tmp / "port_run" / "etude_decoder_config.json")
    jax_training.save_params_only(tmp / "jax_run" / "model",
                                  load_params_only(tmp / "port_run" / "model"), jconfig)
    return tmp, songs, data, vocab


def jax_params(env):
    tmp = env[0]
    jconfig = jdec.EtudeDecoderConfig.from_json_file(tmp / "jax_run" / "etude_decoder_config.json")
    return jconfig, jax_training.load_params_only(tmp / "jax_run" / "model",
                                                  jdec.init_params(jconfig, seed=0))


def _common(env, side):
    tmp, songs, data, _ = env
    return ["--run", str(tmp / f"{side}_run"), "--vocab", str(data / "vocab.json"),
            "--corpus", str(songs), "--dataset-dir", str(data)]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _recording(monkeypatch, cls, replay=None):
    """Wraps `cls.generate_batch`: each call's (streams, attributes, forced
    history, output) is recorded; with `replay`, the outputs are taken from
    it in order instead of generated."""
    calls, original = [], cls.generate_batch

    def generate_batch(self, model, bars, attrs, **kw):
        out = (replay.pop(0)[3] if replay is not None
               else original(self, model, bars, attrs, **kw))
        calls.append((bars, attrs, kw.get("forced_history_y"), out))
        return out

    monkeypatch.setattr(cls, "generate_batch", generate_batch)
    return calls


def test_eval_distilled_teacher_forced_oracle_equals_jax(tmp_path, corpus_env, capsys,
                                                         monkeypatch):
    """--teacher-forced-history --oracle-attrs, greedy. The engines get the
    same condition bars, oracle bins and forced bars as in the JAX script,
    and the port's tokens equal the JAX engine's bar for bar (up to a
    near-tie). Given the JAX engine's tokens, the port's MIDIs and JSON line
    equal the JAX script's."""
    flags = ["--songs", "2", "--teacher-forced-history", "--oracle-attrs"]
    jax_calls = _recording(monkeypatch, jgen.GenerationEngine)
    assert jax_eval.main([*_common(corpus_env, "jax"), *flags,
                          "--out", str(tmp_path / "jax")]) == 0
    ref = _last_json(capsys)
    assert len(jax_calls) == 2 and ref["songs"] == 2 and ref["oracle_attrs"] is True

    result = eval_distilled.run([*_common(corpus_env, "port"), *flags,
                                 "--out", str(tmp_path / "port"), "--device", "cpu"])
    assert set(result.agg) == set(ref)
    jconfig, params = jax_params(corpus_env)
    vocab = corpus_env[3]
    jengine = jgen.GenerationEngine(jconfig, vocab.bar_bos_id, vocab.bar_eos_id,
                                    pad_id=vocab.pad_id, prompt_buckets=(512,),
                                    max_bar_token_limit=64)
    for entry, (bars, attrs, forced, out) in zip(result.songs, jax_calls):
        assert [entry["src_bars"]] == bars and [entry["per_bar"]] == attrs
        assert [entry["tgt_bars"]] == forced
        assert len({tuple(sorted(b.items())) for b in entry["per_bar"]}) > 1
        _bars_equal_up_to_ties(entry["generated"], out[0], jconfig, params, jengine,
                               entry["src_bars"], entry["per_bar"], entry["tgt_bars"])

    replayed = _recording(monkeypatch, tgen.GenerationEngine, replay=list(jax_calls))
    assert eval_distilled.main([*_common(corpus_env, "port"), *flags, "--out",
                                str(tmp_path / "replay"), "--device", "cpu"]) == 0
    assert len(replayed) == 2 and _last_json(capsys) == ref
    for song in ("CPOP01", "CPOP02"):
        notes = read_midi_notes(tmp_path / "replay" / f"{song}_ours.mid")
        assert notes and notes == read_midi_notes(tmp_path / "jax" / f"{song}_ours.mid")


def test_eval_distilled_free_running(tmp_path, corpus_env, capsys):
    """Default attributes, both engines: the JAX keys; the rebuild engine's
    bar 0 equals the JAX engine's at the script's shapes (up to a near-tie)."""
    _, _, _, vocab = corpus_env
    results = {}
    for engine in ("rebuild", "stream"):
        result = results[engine] = eval_distilled.run(
            [*_common(corpus_env, "port"), "--songs", "1", "--engine", engine,
             "--out", str(tmp_path / engine), "--device", "cpu"])
        assert set(result.agg) == {"songs", "mean_rgc", "mean_ipe", "mean_onset_f1_vs_target",
                                   "mean_notes", "oracle_attrs", "predicted_attrs",
                                   "temperature", "engine"}
        assert result.agg["engine"] == engine and result.agg["songs"] == 1
        assert (tmp_path / engine / "CPOP01_ours.mid").exists()
    entry = results["rebuild"].songs[0]
    jconfig, params = jax_params(corpus_env)
    jengine = jgen.GenerationEngine(jconfig, vocab.bar_bos_id, vocab.bar_eos_id,
                                    pad_id=vocab.pad_id, prompt_buckets=(512,),
                                    max_bar_token_limit=64)
    bar0 = jengine.generate(params, entry["src_bars"][:1], entry["per_bar"][:1])
    _bars_equal_up_to_ties(entry["generated"][:1], bar0, jconfig, params, jengine,
                           entry["src_bars"], entry["per_bar"], [])
    # Teacher-forced history needs the rebuild engine, as in JAX.
    assert eval_distilled.main([*_common(corpus_env, "port"), "--engine", "stream",
                                "--teacher-forced-history", "--device", "cpu",
                                "--out", str(tmp_path / "x")]) == 1


def test_eval_engine_parity_keys_and_reuse(tmp_path, corpus_env, capsys, monkeypatch):
    argv = [*_common(corpus_env, "port")[:4], "--songs", "1"]
    extra = ["--corpus", str(corpus_env[1]), "--dataset-dir", str(corpus_env[2])]
    assert eval_engine_parity.main([*argv, *extra, "--out", str(tmp_path / "port"),
                                    "--device", "cpu"]) == 0
    ours = _last_json(capsys)
    main = jax_parity.eval_distilled.main
    monkeypatch.setattr(jax_parity.eval_distilled, "main", lambda a: main([*a, *extra]))
    assert jax_parity.main([*_common(corpus_env, "jax")[:4], "--songs", "1",
                            "--out", str(tmp_path / "jax")]) == 0
    ref = _last_json(capsys)
    assert set(ours) == set(ref) == PARITY_KEYS
    assert [set(r) for r in ours["rows"]] == [set(r) for r in ref["rows"]] == [PARITY_ROW_KEYS]
    assert ours["rows"][0]["song"] == ref["rows"][0]["song"] == "CPOP01"
    assert 0.0 <= ours["mean_cross_f1"] <= 1.0
    # --reuse scores the existing outputs without generating.
    monkeypatch.setattr(eval_distilled, "main", lambda a: pytest.fail("regenerated"))
    assert eval_engine_parity.main([*argv, *extra, "--out", str(tmp_path / "port"),
                                    "--device", "cpu", "--reuse"]) == 0
    assert _last_json(capsys) == ours


# ------------------------------------------------------ sweep_sampling
def _stage(cache: Path, songs: Path, names, seconds: float):
    """Stage 1-2 outputs the sweep reuses: the condition (etude_e), the
    RGC grid of etude_d and the volume of a render, per song."""
    from etude_tpu_torch.data.synthetic import render_piano

    for name in names:
        work = cache / name / "work"
        work.mkdir(parents=True)
        notes = [n for n in read_midi_notes(songs / name / "etude_e.mid")
                 if n["onset"] < seconds - 2]
        (work / "extract.json").write_text(json.dumps(notes))
        tempo = distill_dataset.estimate_tempo_grid(read_midi_notes(songs / name / "etude_d.mid"))
        (work / "tempo.json").write_text(json.dumps(tempo))
        wav = cache / name / "song.wav"
        save_wav(wav, render_piano(notes, seconds, sr=44100), 44100)
        save_volume_map(analyze_volume(wav), work / "volume.json")


def test_sweep_sampling_equals_jax_greedy(tmp_path, corpus_env, capsys, monkeypatch):
    tmp, songs, data, vocab = corpus_env
    names = ["CPOP01", "CPOP02"]
    _stage(tmp_path / "port_cache", songs, names, 20.0)
    shutil.copytree(tmp_path / "port_cache", tmp_path / "jax_cache")
    settings = tmp_path / "settings.json"
    settings.write_text(json.dumps({
        "paths": {"decoder_vocab": str(data / "vocab.json"),
                  "decoder_config": str(tmp / "port_run" / "etude_decoder_config.json"),
                  "decoder_model": str(tmp / "port_run" / "model")},
        "decoder": {"max_bar_token_limit": 64}}))
    flags = ["--songs", "2", "--seconds", "20", "--temps", "0", "0.7", "--seeds", "1"]
    assert sweep_sampling.main([*flags, "--corpus", str(songs), "--config", str(settings),
                                "--cache", str(tmp_path / "port_cache"),
                                "--out", str(tmp_path / "port.json"), "--device", "cpu"]) == 0
    ours = _last_json(capsys)

    import etude_tpu.config as jax_config
    import etude_tpu.utils.model_loader as jax_loader

    jconfig, params = jax_params(corpus_env)
    load_config = jax_config.load_config
    monkeypatch.setattr(jax_sweep, "CORPUS", songs)
    monkeypatch.setattr(jax_config, "load_config", lambda path=None, overrides=None: load_config(
        None, {"paths": {"decoder_vocab": str(data / "vocab.json")},
               "decoder": {"max_bar_token_limit": 64}}))
    monkeypatch.setattr(jax_loader, "load_etude_decoder",
                        lambda *a, **kw: (params, jconfig))
    assert jax_sweep.main([*flags, "--cache", str(tmp_path / "jax_cache"),
                           "--out", str(tmp_path / "jax.json")]) == 0
    ref = _last_json(capsys)

    payload = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    assert set(payload) == set(want) == {"songs", "seconds", "attrs", "refs", "results"}
    assert payload["songs"] == want["songs"] == names and payload["refs"] == want["refs"]
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        assert set(a) == set(b) and [set(s) for s in a["seeds"]] == [set(s) for s in b["seeds"]]
        assert (a["temperature"], a["top_p"]) == (b["temperature"], b["top_p"])
    greedy = [{k: v for k, v in row.items() if k != "seeds"} for row in (ours[0], ref[0])]
    assert greedy[0] == greedy[1]
    for name in names:
        for config in ("T0.0_p0.9_s0", "T0.7_p0.9_s0"):
            assert read_midi_notes(tmp_path / "port_cache" / name / f"{config}.mid") is not None
        a = read_midi_notes(tmp_path / "port_cache" / name / "T0.0_p0.9_s0.mid")
        assert a and a == read_midi_notes(tmp_path / "jax_cache" / name / "T0.0_p0.9_s0.mid")
