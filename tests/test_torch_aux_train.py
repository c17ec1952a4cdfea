"""Aux training in the port (etude_tpu_torch/train_aux.py,
parallel/train_step.py `make_aux_optimizer`, utils/training.py's params-only
format) against the JAX package's script (scripts/train_aux_synthetic.py),
on the CPU at narrow widths.

Tolerances: the schedule to one f32 ulp of the peak rate (both evaluate it
in f32). Three optimizer steps of each model from the same parameters on
the same batches (f32 on both sides): losses to 1e-5 relative, every
parameter to 1e-6 absolute (the parameters are O(0.02) and each step moves
them by at most about the rate); the attention key biases, whose true
gradient is zero (tests/test_torch_aux_losses.py), take Adam steps of
either sign on rounding noise in both packages and are held to twice the
sum of the rates applied, as tests/test_torch_train_step.py holds the
decoder's. Exports: floats stored as f16 and read back as f32, exactly.
"""

import argparse
import functools
import importlib.util
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from etude_tpu.models import amt as jax_amt
from etude_tpu.models import beat_transformer as jax_bt
from etude_tpu.models import separator as jax_sep
from etude_tpu_torch import train_aux
from etude_tpu_torch.models import amt, beat_transformer as bt, separator as sep
from etude_tpu_torch.models.decoder import EtudeDecoderConfig
from etude_tpu_torch.parallel.train_step import make_aux_optimizer
from etude_tpu_torch.utils.training import (
    flatten_tree, load_params_only, save_aux_params, save_params_only, unflatten_tree,
)
from etude_tpu_torch.weights import (
    amt_from_jax, beat_transformer_from_jax, init_amt_params_np, init_beat_params_np,
    init_decoder_params_np, init_separator_params_np, separator_from_jax,
)

REPO = Path(__file__).resolve().parent.parent
PARAM_ATOL = 1e-6
LOSS_RTOL = 1e-5
# Narrow widths of each model; the data keep their published layouts (128
# mel bins of 5 stems, 256 log-mel bins, the 2049-bin STFT).
SMALL = {
    "beat": dict(dmodel=32, nhead=8, d_hid=64, nlayers=3, instr_layers=(1,)),
    "amt": dict(n_frame=16, hid_dim=16, pf_dim=32, encoder_n_layer=1, decoder_n_layer=2,
                encoder_n_head=2, decoder_n_head=2),
    "separator": dict(base_channels=8, depth=2, freq_bins=64, channel_cap=16),
}
PORT_CONFIGS = {"beat": bt.BeatTransformerConfig, "amt": amt.AMTConfig,
                "separator": sep.SeparatorConfig}
JAX_CONFIGS = {"beat": jax_bt.BeatTransformerConfig, "amt": jax_amt.AMTConfig,
               "separator": jax_sep.SeparatorConfig}
KEY_BIAS = {"beat": r"layers/\d+/(instr/)?k/b$", "amt": r"(attn|self|cross)/k/b$",
            "separator": None}


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "train_aux_synthetic", REPO / "scripts" / "train_aux_synthetic.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def small(monkeypatch):
    """The CLI's modes at the narrow widths."""
    for name, kw in SMALL.items():
        monkeypatch.setitem(train_aux.TASKS, name, functools.partial(
            train_aux.TASKS[name], config=PORT_CONFIGS[name](**kw)))


def flat(tree):
    return flatten_tree(tree)


# ------------------------------------------------------------------ schedule
@pytest.mark.parametrize("steps", [1, 2, 3, 19, 40, 1500])
def test_aux_schedule_equals_optax(steps):
    lr = 4e-4
    ours = make_aux_optimizer(lr, steps).schedule
    warmup = max(steps // 20, 1)
    ref = optax.join_schedules(
        [optax.linear_schedule(0.0, lr, warmup), optax.cosine_decay_schedule(lr, max(steps, 2))],
        boundaries=[warmup])
    counts = np.unique(np.concatenate([np.arange(0, min(steps, 60) + 3),
                                       np.linspace(0, steps + 2, 50).astype(int)]))
    got = np.array([float(ours(torch.tensor(c, dtype=torch.int32))) for c in counts])
    want = np.array([float(ref(jnp.int32(c))) for c in counts])
    np.testing.assert_allclose(got, want, rtol=0, atol=np.spacing(np.float32(lr)))
    assert got[0] == 0.0


def test_aux_optimizer_is_optax_adamw_defaults():
    tx = make_aux_optimizer(1e-3, 100)
    assert (tx.b1, tx.b2, tx.eps, tx.weight_decay, tx.clip_grad_norm) == (0.9, 0.999, 1e-8,
                                                                          0.01, 1.0)
    assert (tx.schedule.warmup_steps, tx.schedule.decay_steps) == (5, 100)


# ----------------------------------------------------------- steps vs JAX
def task_args(name, steps=3):
    return argparse.Namespace(seed=0, batch=2, lr=train_aux.DEFAULTS[name][1], steps=steps,
                              eval_clips=1, beat_frames=48, sep_frames=24, init_from=None)


def jax_loss(name, config):
    if name == "beat":
        return lambda p, b: jax_bt.loss_fn(p, config, b, jnp.float32)
    if name == "separator":
        return lambda p, b: jax_sep.loss_fn(p, config, b, jnp.float32)

    def loss(p, b):   # the script's amt loss (scripts/train_aux_synthetic.py:328-332)
        pos_weights = dict(b["pos_w"])
        pos_weights.update({"velocity": 1.0, "velocity_silent": 0.0})
        return jax_amt.loss_fn(p, config, b, jnp.float32, remat=True,
                               pos_weights=pos_weights, head_scales=train_aux.AMT_HEAD_SCALES)
    return loss


@pytest.mark.parametrize("name", ["beat", "amt", "separator"])
def test_three_steps_match_the_jax_train_loop(name, script):
    args = task_args(name)
    task = train_aux.TASKS[name](args, torch.device("cpu"),
                                 config=PORT_CONFIGS[name](**SMALL[name]))
    batches = [task.gen(i) for i in range(args.steps)]
    init = {"beat": init_beat_params_np, "amt": init_amt_params_np,
            "separator": init_separator_params_np}[name]
    params = init(PORT_CONFIGS[name](**SMALL[name]), seed=args.seed)

    losses, _, _, stats = train_aux.train_loop(name, task.model, task.loss,
                                               lambda i: batches[i], args.steps, args.lr, "cpu",
                                               log_every=1)
    jparams, jstats = script.train_loop(
        name, jax.tree.map(jnp.asarray, params), jax_loss(name, JAX_CONFIGS[name](**SMALL[name])),
        lambda i: batches[i], args.steps, args.lr, log_every=1)
    for key in ("first_loss", "final_loss"):
        np.testing.assert_allclose(stats[key], jstats[key], rtol=LOSS_RTOL, err_msg=key)
    assert stats["steps"] == jstats["steps"] == 3
    np.testing.assert_allclose(losses[0], jstats["first_loss"], rtol=LOSS_RTOL)

    tx = make_aux_optimizer(args.lr, args.steps)
    rates = sum(float(tx.schedule(c)) for c in range(args.steps))
    ours, ref = flat(task.to_jax(task.model)), flat(jax.device_get(jparams))
    assert set(ours) == set(ref)
    moved = 0.0
    for key, want in ref.items():
        noisy = KEY_BIAS[name] and re.search(KEY_BIAS[name], key)
        atol = 2 * rates if noisy else PARAM_ATOL
        np.testing.assert_allclose(ours[key], want, rtol=0, atol=atol, err_msg=key)
        moved = max(moved, float(np.abs(want - flat(params)[key]).max()))
    assert moved > 10 * PARAM_ATOL   # the steps did move the parameters


# ----------------------------------------------------------------------- CLI
def test_cli_trains_every_mode_and_its_exports_load(tmp_path, small):
    out = tmp_path / "aux"
    assert train_aux.main(["all", "--device", "cpu", "--steps", "2", "--batch", "2",
                           "--eval-clips", "1", "--beat-frames", "40", "--sep-frames", "16",
                           "--output-dir", str(out)]) == 0
    keys = {"beat_detector": {"beat_f_measure", "corpus", "corpus_mix", "train_frames"},
            "extractor": {"onset_f1", "corpus"},
            "separator": {"stem_sdr_db", "baseline_sdr_db", "corpus", "train_frames"}}
    build = {"beat_detector": (beat_transformer_from_jax, "beat"),
             "extractor": (amt_from_jax, "amt"), "separator": (separator_from_jax, "separator")}
    for export, extra in keys.items():
        meta = json.loads((out / export / "metadata.json").read_text())
        assert {"first_loss", "final_loss", "steps", "seconds", "model"} | extra <= set(meta)
        assert meta["steps"] == 2 and np.isfinite(meta["final_loss"])
        values = [v for k, v in meta.items() if k in extra and isinstance(v, float)]
        assert all(np.isfinite(values))
        params = load_params_only(out / export / "latest")
        fn, name = build[export]
        model = fn(params, PORT_CONFIGS[name](**SMALL[name]))
        assert all(torch.isfinite(p).all() for p in model.parameters())
    assert not (REPO / "checkpoints" / "beat_detector" / "latest").exists()


def test_cli_warm_starts_from_a_port_export(tmp_path, small):
    """--init-from reads the port's export: one step, whose rate is
    schedule(0) = 0, gives back its weights (decay is scaled by the rate
    too)."""
    out = tmp_path / "a"
    cfg = sep.SeparatorConfig(**SMALL["separator"])
    start = init_separator_params_np(cfg, seed=42)
    save_aux_params(tmp_path / "init" / "latest", start)
    runs = train_aux.run(["separator", "--device", "cpu", "--steps", "1", "--batch", "1",
                          "--eval-clips", "1", "--sep-frames", "16", "--init-from",
                          str(tmp_path / "init" / "latest"), "--output-dir", str(out)])
    got = flat(load_params_only(runs[0].export))
    for key, value in flat(start).items():
        np.testing.assert_array_equal(got[key], value.astype(np.float16).astype(np.float32))


@pytest.mark.parametrize("argv,error", [
    (["beat", "--output-dir", str(REPO / "checkpoints" / "x")], ValueError),
])
def test_cli_refuses_what_it_does_not_port(argv, error):
    with pytest.raises(error):
        train_aux.run([*argv, "--device", "cpu"])


# ------------------------------------------------------- corpus modes (CLI)
# Each mode's metadata keys beside the loop's (first_loss, final_loss,
# steps, seconds), as the JAX script writes them (scripts/
# train_aux_synthetic.py :194-229, :483-493, :694-707, :835-840).
BEAT_CORPUS_KEYS = {"beat_f_corpus", "beat_f_corpus_octave", "beat_f_per_song",
                    "beat_f_synthetic", "corpus", "corpus_frac", "train_song_versions",
                    "eval_songs", "warm_start", "train_frames", "model"}
AMT_CORPUS_KEYS = {"onset_f1_corpus", "onset_f1_per_song", "eval_seconds", "corpus",
                   "corpus_frac", "train_songs", "eval_songs", "warm_start", "model"}
BEAT_SCENES_KEYS = {"beat_f_measure", "corpus", "corpus_mix", "train_frames", "model",
                    "beat_f_corpus", "beat_f_corpus_octave", "beat_f_per_song", "eval_songs"}
SEPARATOR_KEYS = {"stem_sdr_db", "baseline_sdr_db", "corpus", "train_frames", "model"}
CORPUS_CASES = {
    "beat-corpus": (["beat-corpus", "--corpus-limit", "2"], "beat_detector", BEAT_CORPUS_KEYS,
                    "rendered-corpus(serving-chain)+synthetic-scenes"),
    "amt-corpus": (["amt-corpus"], "extractor", AMT_CORPUS_KEYS,
                   "rendered-corpus(serving-chain)+synthetic"),
    "beat-scenes": (["beat", "--scenes-dir", "{scenes}", "--corpus-mix", "0.5"],
                    "beat_detector", BEAT_SCENES_KEYS, "synthetic-scenes + corpus-piano-scenes"),
    "separator-pseudopop-mix": (["separator", "--pseudopop-mix", "0.5"], "separator",
                                SEPARATOR_KEYS,
                                "synthetic-stems + pseudo-pop audio stems (mix 0.50)"),
    # With a cache the JAX script names no pseudo-pop rows in `corpus`.
    "separator-pseudopop-cache": (["separator", "--pseudopop-mix", "0.5", "--pseudopop-cache",
                                   "{cache}"], "separator", SEPARATOR_KEYS, "synthetic-stems"),
}


@pytest.fixture
def corpus_cli(tmp_path, monkeypatch, small):
    """A synthetic corpus at `corpus_render.CORPUS_ROOT`, scene and
    pseudo-pop shards in the JAX scripts' formats, the corpus modes at the
    narrow widths, and the serving models of their features and
    evaluations (separator, BeatDetector, extractor) too."""
    from etude_tpu_torch.data import beat_detector, corpus_render, extractor, separation
    from etude_tpu_torch.tools.synthetic_corpus import write_corpus

    write_corpus(tmp_path / "songs", n_songs=6, seconds=(20.0, 30.0), seed=0)
    monkeypatch.setattr(corpus_render, "CORPUS_ROOT", tmp_path / "songs")
    for name, model in (("beat-corpus", "beat"), ("amt-corpus", "amt")):
        monkeypatch.setitem(train_aux.TASKS, name, functools.partial(
            train_aux.TASKS[name], config=PORT_CONFIGS[model](**SMALL[model])))
    monkeypatch.setattr(separation, "SeparatorConfig",
                        lambda: sep.SeparatorConfig(**SMALL["separator"]))
    monkeypatch.setattr(beat_detector, "beat_model_config_from",
                        lambda config: bt.BeatTransformerConfig(**SMALL["beat"]))
    monkeypatch.setattr(extractor, "amt_config_from",
                        lambda config, n_frame=None: amt.AMTConfig(**SMALL["amt"]))
    # Two intra-op threads: the models are narrow, and a CPU shared by
    # several test workers loses more to contending threads than it gains.
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    rng = np.random.default_rng(0)
    (tmp_path / "scenes").mkdir()
    np.savez_compressed(tmp_path / "scenes" / "shard_0000.npz",
                        x=rng.uniform(-80, 0, (3, 5, 512, 128)).astype(np.float16),
                        activations=rng.uniform(0, 1, (3, 512, 2)).astype(np.float16),
                        tempo=rng.integers(0, 300, 3).astype(np.int32))
    (tmp_path / "cache").mkdir()
    np.savez_compressed(tmp_path / "cache" / "shard_0000.npz",
                        mix_mag=rng.uniform(0, 3, (3, 256, 2049)).astype(np.float16),
                        stem_mags=rng.uniform(0, 1, (3, 5, 256, 2049)).astype(np.float16))
    yield tmp_path
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", list(CORPUS_CASES))
def test_cli_runs_the_corpus_modes(case, corpus_cli):
    """Each corpus mode and option trains on the synthetic corpus and writes
    an export whose metadata.json has the JAX script's keys, with finite
    values; the corpus modes warm-start from the run's own export when it
    is there; nothing is written under checkpoints/."""
    argv, export, keys, corpus = CORPUS_CASES[case]
    argv = [a.format(scenes=corpus_cli / "scenes", cache=corpus_cli / "cache") for a in argv]
    out = corpus_cli / "out"
    name = argv[0]
    warm = None
    if name == "amt-corpus":
        warm = out / "extractor" / "latest"
        save_aux_params(warm, init_amt_params_np(amt.AMTConfig(**SMALL["amt"]), seed=5))
    if name in ("beat", "beat-corpus"):
        save_aux_params(out / "separator" / "latest",
                        init_separator_params_np(sep.SeparatorConfig(**SMALL["separator"]), 5))
    checkpoints = sorted((REPO / "checkpoints").rglob("*"))
    runs = train_aux.run([*argv, "--device", "cpu", "--steps", "2", "--batch", "2",
                          "--eval-clips", "1", "--beat-frames", "40", "--eval-seconds", "12",
                          "--output-dir", str(out)])
    assert [r.name for r in runs] == [name] and runs[0].export == out / export / "latest"
    assert len(runs[0].losses) == 2 and all(np.isfinite(runs[0].losses))
    meta = json.loads((out / export / "metadata.json").read_text())
    assert set(meta) == {"first_loss", "final_loss", "steps", "seconds"} | keys
    assert meta["corpus"] == corpus and meta["steps"] == 2
    for key, value in meta.items():
        if isinstance(value, float):
            assert np.isfinite(value), key
    if name in ("beat-corpus", "amt-corpus"):
        assert meta["warm_start"] == (str(warm) if warm else None)
    if "eval_songs" in keys:
        held_out = ["CPOP01"] if name == "beat-corpus" else ["CPOP01", "CPOP04"]
        assert meta["eval_songs"] == held_out
    if name == "beat-corpus":
        assert meta["train_song_versions"] == 4
        assert sorted(meta["beat_f_per_song"]) == ["CPOP01"]
        assert len(list((out / "beat_corpus_cache").glob("*.npz"))) == 4
    if name == "amt-corpus":
        assert meta["train_songs"] == 4 and sorted(meta["onset_f1_per_song"]) == meta["eval_songs"]
    fn, model = {"beat_detector": (beat_transformer_from_jax, "beat"),
                 "extractor": (amt_from_jax, "amt"),
                 "separator": (separator_from_jax, "separator")}[export]
    loaded = fn(load_params_only(out / export / "latest"), PORT_CONFIGS[model](**SMALL[model]))
    assert all(torch.isfinite(p).all() for p in loaded.parameters())
    assert sorted((REPO / "checkpoints").rglob("*")) == checkpoints


def test_cli_refuses_an_orbax_warm_start(tmp_path):
    orbax_dir = REPO / "checkpoints" / "beat_detector" / "latest.ckpt"
    if not orbax_dir.exists():
        pytest.skip("the committed orbax beat checkpoint is not in this checkout")
    with pytest.raises(RuntimeError, match="orbax"):
        train_aux.run(["beat", "--device", "cpu", "--init-from", str(orbax_dir),
                       "--output-dir", str(tmp_path)])


# ------------------------------------------------------- params-only format
@pytest.mark.parametrize("name", ["beat", "amt", "separator"])
def test_published_trees_round_trip_through_the_export(tmp_path, name):
    """The published widths' trees, lists of layers included: stored as
    f16, read back as f32 into the same structure."""
    tree = {"beat": lambda: init_beat_params_np(bt.BeatTransformerConfig()),
            "amt": lambda: init_amt_params_np(amt.AMTConfig()),
            "separator": lambda: init_separator_params_np(sep.SeparatorConfig())}[name]()
    save_aux_params(tmp_path / "latest", tree, metadata={"steps": 0})
    with np.load(tmp_path / "latest" / "params.npz") as f:
        assert {f[k].dtype for k in f.files} == {np.dtype(np.float16)}
    back = load_params_only(tmp_path / "latest")
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for key, value in flat(tree).items():
        got = flat(back)[key]
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, value.astype(np.float16).astype(np.float32))
    assert json.loads((tmp_path / "metadata.json").read_text()) == {"steps": 0}


def test_list_indices_are_path_elements():
    tree = {"layers": [{"w": np.zeros(2)}, {"w": np.ones(2)}], "out": {"b": np.ones(1)}}
    flat_tree = flatten_tree(tree)
    assert sorted(flat_tree) == ["layers/0/w", "layers/1/w", "out/b"]
    back = unflatten_tree(flat_tree)
    assert isinstance(back["layers"], list) and len(back["layers"]) == 2
    np.testing.assert_array_equal(back["layers"][1]["w"], np.ones(2))
    with pytest.raises(ValueError):
        unflatten_tree({"layers/0/w": np.zeros(1), "layers/2/w": np.zeros(1)})


def test_decoder_exports_still_load_as_f32(tmp_path):
    """The decoder's export (f32, no lists) reads back bit for bit, under
    the paths it always had."""
    config = EtudeDecoderConfig(vocab_size=40, hidden_size=16, num_hidden_layers=2,
                                num_attention_heads=2, intermediate_size=32,
                                attribute_emb_dim=4)
    tree = init_decoder_params_np(config, seed=1)
    save_params_only(tmp_path / "model", tree, config)
    with np.load(tmp_path / "model" / "params.npz") as f:
        assert "layers/qkv/w" in f.files and f["layers/qkv/w"].dtype == np.float32
    back = load_params_only(tmp_path / "model")
    for key, value in flat(tree).items():
        assert flat(back)[key].dtype == np.float32
        np.testing.assert_array_equal(flat(back)[key], value)
