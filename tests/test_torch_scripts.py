"""The port's scripts (etude_tpu_torch/scripts/, etude_tpu_torch/entry.py)
against the JAX package's (scripts/*.py, __graft_entry__.py) on the same
inputs, on the CPU.

Tolerances:
- dagger_rollouts: a tiny decoder (init std 0.1, so greedy bars run long)
  from one seed, written by each package's own export. The rollout files
  must be equal token for token, or first differ where the JAX logits are a
  near-tie: top-2 margin below TIE_MARGIN, the rule of
  tests/test_torch_generate_stream.py (the engines' bf16 logits differ by
  up to 8.7e-3 per S = 1 step).
- remap_decoder_warmstart, publish_decoder: equal parameters bit for bit
  (the same numpy arrays copied, and cast to f16 by both), equal configs
  and metadata fields.
- run_separation: the committed separator's weights bridged into the port's
  format; the features within DB_ATOL dB of the JAX CLI's with its U-Net
  in f32 (tests/test_torch_separation.py).
- entry: the port's f32 forward on the CPU against the JAX `forward` at f32
  on the JAX `entry()`'s example batch within ENTRY_ATOL (logits of std
  about 0.45; f32 sums in another order through 8 layers: measured
  2.7e-6).
"""

import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from etude_tpu.models import decoder as jdec
from etude_tpu.models import separator as jsep
from etude_tpu.utils import training as jax_training
from etude_tpu_torch import entry, train
from etude_tpu_torch.data.dataset import calculate_bin_edges, split_ids_into_bars
from etude_tpu_torch.data.vocab import Vocab
from etude_tpu_torch.models import generate_stream as tgs
from etude_tpu_torch.models.decoder import EtudeDecoderConfig
from etude_tpu_torch.scripts import (
    dagger_rollouts, publish_decoder, remap_decoder_warmstart, run_separation, supervise_train,
)
from etude_tpu_torch.utils.model_loader import load_etude_decoder
from etude_tpu_torch.utils.training import load_params_only, save_aux_params, save_params_only
from etude_tpu_torch.weights import init_decoder_params_np
from test_torch_dataset import CORPUS
from test_torch_generate_stream import TIE_MARGIN, _jax_replay
from test_torch_separation import CKPT, DB_ATOL, _np_tree, _tone_wav, jax_f32_separator  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
VOCAB = Vocab.load(CORPUS / "vocab.json")
# 640 positions: the engine's 512-token bar cap leaves a 128-position prompt.
TINY = dict(vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64, max_position_embeddings=640,
            attribute_emb_dim=8, initializer_range=0.1)
ENTRY_ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny decoders, one small op after another: one thread is fastest on
    a shared CPU. Restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cut_dataset(dst: Path, songs, n_bars: int) -> Path:
    """A dataset dir of `songs`' `_src`/`_tgt` cut to their first `n_bars`
    bars, with the corpus vocabulary."""
    for song in songs:
        (dst / "tokenized" / song).mkdir(parents=True)
        for kind in ("src", "tgt"):
            ids = np.load(CORPUS / "tokenized" / song / f"{song}_{kind}.npy")
            bars = split_ids_into_bars(ids.astype(int).tolist(), VOCAB.bar_bos_id,
                                       VOCAB.bar_eos_id)[:n_bars]
            np.save(dst / "tokenized" / song / f"{song}_{kind}.npy",
                    np.asarray([t for b in bars for t in b], ids.dtype))
    (dst / "vocab.json").write_bytes((CORPUS / "vocab.json").read_bytes())
    return dst


def port_run(dst: Path, params, config) -> Path:
    save_params_only(dst / "model", params, config)
    return dst


def eos_params(config):
    """Weights whose every logit vector peaks at Bar_EOS: each generated bar
    is [Bar_BOS, Bar_EOS] (for the script's selection and skip rules)."""
    params = init_decoder_params_np(config, seed=0)
    params["final_ln"]["scale"][:] = 0.0
    params["final_ln"]["bias"][:] = 0.0
    params["final_ln"]["bias"][0] = 1.0
    params["lm_head"][0, VOCAB.bar_eos_id] = 10.0
    return params


def no_bos_params(config):
    """Seeded weights whose Bar_BOS logit is always -100: greedy bars never
    open a new bar inside one, so the dataset keeps their rollouts (a file
    whose bar count differs from the teacher's is ignored)."""
    params = init_decoder_params_np(config, seed=0)
    params["final_ln"]["scale"][0] = 0.0
    params["final_ln"]["bias"][0] = 1.0
    params["lm_head"][0, :] = 0.0
    params["lm_head"][0, VOCAB.bar_bos_id] = -100.0
    return params


# ------------------------------------------------------------ dagger_rollouts
@pytest.fixture(scope="module")
def rollouts(tmp_path_factory):
    """Both scripts on 3 songs cut to 3 bars, --batch 2, from one tiny
    decoder exported by each package."""
    tmp = tmp_path_factory.mktemp("rollouts")
    songs = ("0001", "0002", "0003")
    jconfig = jdec.EtudeDecoderConfig(**TINY)
    config = EtudeDecoderConfig(**TINY)
    params = jdec.init_params(jconfig, seed=0)
    jax_training.save_params_only(tmp / "jax_run" / "model", params, jconfig)
    port_run(tmp / "port_run", init_decoder_params_np(config, seed=0), config)
    ours = cut_dataset(tmp / "port_data", songs, 3)
    ref = cut_dataset(tmp / "jax_data", songs, 3)
    run = dagger_rollouts.run(["--run", str(tmp / "port_run"), "--dataset-dir", str(ours),
                               "--batch", "2", "--device", "cpu"])
    assert jax_script("dagger_rollouts").main(
        ["--run", str(tmp / "jax_run"), "--dataset-dir", str(ref), "--batch", "2"]) == 0
    return songs, ours, ref, run, jconfig, params


def test_rollouts_match_jax(rollouts):
    songs, ours, ref, run, jconfig, params = rollouts
    assert run is not None and len(run.written) == 3
    assert run.bars == 9 and run.tokens == sum(
        len(np.load(p)) for p in run.written)
    engine = tgs.StreamingGenerationEngine(EtudeDecoderConfig(**TINY), VOCAB.bar_bos_id,
                                           VOCAB.bar_eos_id, VOCAB.pad_id)
    src_songs = dagger_rollouts.load_songs(ours / "tokenized", VOCAB)
    edges = calculate_bin_edges([a for s in src_songs for a in s["attrs"]])
    for song, s in zip(songs, src_songs):
        a = np.load(ours / "tokenized" / song / f"{song}_hist.npy")
        b = np.load(ref / "tokenized" / song / f"{song}_hist.npy")
        assert a.dtype == b.dtype == np.int32
        bars_a = split_ids_into_bars(a.tolist(), VOCAB.bar_bos_id, VOCAB.bar_eos_id)
        bars_b = split_ids_into_bars(b.tolist(), VOCAB.bar_bos_id, VOCAB.bar_eos_id)
        assert len(bars_b) == 3 and len(bars_a) >= 1
        if np.array_equal(a, b):
            continue
        # The first divergence must be at a near-tie of the JAX logits.
        n = min(len(a), len(b))
        first = next((i for i in range(n) if a[i] != b[i]), n)
        bar = int(np.sum(b[:first] == VOCAB.bar_bos_id)) - 1
        step = first - int(np.flatnonzero(b[:first + 1] == VOCAB.bar_bos_id)[-1]) - 1
        attrs = dagger_rollouts.bin_maps(s["attrs"], edges)
        logits = next(l for at, l in _jax_replay(jconfig, params, engine, s["src_bars"], attrs,
                                                   bars_b) if at == (bar, step))
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] < TIE_MARGIN, (song, bar, step, top2[1] - top2[0])


def test_rollouts_selection_skip_and_force(tmp_path):
    """--stride/--stride-offset/--limit pick songs after the edges are
    taken; existing files are kept without --force; --force rewrites all
    but those newer than --skip-newer-than."""
    config = EtudeDecoderConfig(**TINY)
    run_dir = port_run(tmp_path / "run", eos_params(config), config)
    data = cut_dataset(tmp_path / "data", ("0001", "0002", "0003", "0004", "0005"), 2)
    common = ["--run", str(run_dir), "--dataset-dir", str(data), "--device", "cpu"]

    def hist(song):
        return data / "tokenized" / song / f"{song}_hist.npy"

    first = dagger_rollouts.run([*common, "--stride", "2", "--stride-offset", "1"])
    assert [p.parent.name for p in first.written] == ["0002", "0004"]
    np.testing.assert_array_equal(np.load(hist("0002")),
                                  [VOCAB.bar_bos_id, VOCAB.bar_eos_id] * 2)
    assert first.single_token_chunks == 2 * 2  # per bar: the Bar_BOS and one step
    limited = dagger_rollouts.run([*common, "--stride", "2", "--limit", "2"])
    assert [p.parent.name for p in limited.written] == ["0001", "0003"]
    again = dagger_rollouts.run(common)
    assert [p.parent.name for p in again.written] == ["0005"]
    assert dagger_rollouts.run(common).written == []

    old = time.time() - 100
    for song in ("0001", "0002", "0003", "0004", "0005"):
        os.utime(hist(song), (old, old))
    marker = tmp_path / "marker"
    marker.touch()
    os.utime(marker, (old + 50, old + 50))
    os.utime(hist("0003"), (old + 80, old + 80))   # newer than the marker: kept
    forced = dagger_rollouts.run([*common, "--force", "--skip-newer-than", str(marker)])
    assert sorted(p.parent.name for p in forced.written) == ["0001", "0002", "0004", "0005"]
    assert hist("0003").stat().st_mtime == old + 80
    assert len(dagger_rollouts.run([*common, "--force"]).written) == 5


def test_rollouts_global_edges(tmp_path, monkeypatch):
    """The bins come from edges over every song, not over the selection:
    the same song's conditioning under --limit 1 equals the full run's."""
    config = EtudeDecoderConfig(**TINY)
    run_dir = port_run(tmp_path / "run", eos_params(config), config)
    # Songs of different base songs (variants of one are adjacent and bin
    # alike).
    data = cut_dataset(tmp_path / "data", ("0001", "0050", "0100"), 6)
    seen = []

    def spy(self, model, bars, attrs, **kw):
        seen.append(attrs)
        return [[[VOCAB.bar_bos_id, VOCAB.bar_eos_id]] * len(b) for b in bars]

    monkeypatch.setattr(tgs.StreamingGenerationEngine, "generate_batch", spy)
    common = ["--run", str(run_dir), "--dataset-dir", str(data), "--device", "cpu", "--force"]
    dagger_rollouts.run([*common, "--limit", "1"])
    dagger_rollouts.run(common)
    assert seen[0][0] == seen[1][0]
    # The control: edges over each song alone bin some bar otherwise.
    songs = dagger_rollouts.load_songs(data / "tokenized", VOCAB)
    own = [dagger_rollouts.bin_maps(s["attrs"], calculate_bin_edges(s["attrs"])) for s in songs]
    assert own != seen[1]


def test_rollouts_refusals(tmp_path):
    with pytest.raises(ValueError, match="committed rollouts"):
        dagger_rollouts.run(["--run", str(tmp_path), "--dataset-dir", str(CORPUS), "--force",
                             "--device", "cpu"])
    with pytest.raises(ValueError, match="checkpoints/"):
        dagger_rollouts.run(["--run", str(tmp_path), "--dataset-dir",
                             str(REPO / "checkpoints" / "x"), "--device", "cpu"])


def test_rollouts_feed_the_dagger_fine_tune(tmp_path):
    """The port's train CLI with dagger_history reads the script's files:
    chunks past a song's first bar take the rollout history; without
    dagger_history none does."""
    config = EtudeDecoderConfig(**TINY)
    run_dir = port_run(tmp_path / "run", no_bos_params(config), config)
    data = cut_dataset(tmp_path / "data", ("0001", "0002", "0003"), 4)
    assert len(dagger_rollouts.run(["--run", str(run_dir), "--dataset-dir", str(data),
                                    "--device", "cpu"]).written) == 3
    widths = {k: v for k, v in TINY.items() if k not in ("vocab_size", "initializer_range")}
    shares = {}
    for dagger in (True, False):
        settings = tmp_path / f"dagger_{dagger}.json"
        settings.write_text(json.dumps({
            "env": {"compute_dtype": "float32"},
            "paths": {"dataset_vocab": str(data / "vocab.json"),
                      "tokenized_dir": str(data / "tokenized"),
                      "train_output_dir": str(tmp_path / "out")},
            "decoder": widths,
            "train": {"batch_size": 2, "gradient_accumulation_steps": 1, "max_seq_len": 256,
                      "dagger_history": dagger, "init_from": str(run_dir / "model")},
        }))
        r = train.run(["--config", str(settings), "--device", "cpu", "--max-steps", "2",
                       "--run-id", f"d{dagger}"])
        shares[dagger] = (r.rollout_chunks, r.chunks)
    assert shares[True][0] > 0 and shares[True][1] >= 4
    assert shares[False][0] == 0 and shares[False][1] >= 4


# ------------------------------------------------- remap, publish: port vs JAX
@pytest.fixture(scope="module")
def trained_runs(tmp_path_factory):
    """A run dir per package holding the same tiny decoder (JAX: orbax;
    port: params.npz), the corpus vocab and a metrics.jsonl."""
    tmp = tmp_path_factory.mktemp("runs")
    jconfig = jdec.EtudeDecoderConfig(**TINY)
    config = EtudeDecoderConfig(**TINY)
    params = init_decoder_params_np(config, seed=4)
    jax_training.save_params_only(tmp / "jax" / "model", params, jconfig)
    port_run(tmp / "port", params, config)
    for run in ("jax", "port"):
        (tmp / run / "vocab.json").write_bytes((CORPUS / "vocab.json").read_bytes())
        (tmp / run / "metrics.jsonl").write_text(
            json.dumps({"epoch": 1, "loss": 4.5}) + "\n"
            + json.dumps({"epoch": 2, "step": 9, "loss": 3.25, "tokens_per_sec": 1234.5}) + "\n")
    return tmp, params, jconfig


def jax_params(path: Path, jconfig):
    abstract = jdec.init_params(jconfig, abstract=True)
    return _np_tree(jax_training.load_params_only(path, abstract, cache=False))


def assert_same_tree(a, b, dtype=None):
    fa, fb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        if dtype is not None:
            assert x.dtype == dtype, path
        np.testing.assert_array_equal(x, y, err_msg=str(path))


def test_remap_script_matches_jax(trained_runs):
    tmp, params, jconfig = trained_runs
    vocabs = ["--old-vocab", str(CORPUS / "vocab.json"),
              "--new-vocab", str(REPO / "dataset_distill_r4" / "vocab.json")]
    assert remap_decoder_warmstart.main(["--run", str(tmp / "port"), *vocabs, "--out",
                                         str(tmp / "remap_port"), "--device", "cpu"]) == 0
    assert jax_script("remap_decoder_warmstart").main(
        ["--run", str(tmp / "jax"), *vocabs, "--out", str(tmp / "remap_jax")]) == 0
    ours_cfg = json.loads((tmp / "remap_port" / "etude_decoder_config.json").read_text())
    ref_cfg = json.loads((tmp / "remap_jax" / "etude_decoder_config.json").read_text())
    assert ours_cfg == ref_cfg and ours_cfg["vocab_size"] == 119
    new_jconfig = jdec.EtudeDecoderConfig(**{**TINY, "vocab_size": 119})
    ours = load_params_only(tmp / "remap_port" / "model")
    assert_same_tree(ours, jax_params(tmp / "remap_jax" / "model", new_jconfig), np.float32)
    # Usable as train.init_from and by the serving loader.
    model, config = load_etude_decoder(tmp / "remap_port" / "etude_decoder_config.json",
                                       tmp / "remap_port" / "model", "cpu")
    assert config.vocab_size == 119 and model.lm_head.weight.shape[0] == 119


def test_publish_script_matches_jax(trained_runs):
    tmp, params, jconfig = trained_runs
    meta = ["--meta", json.dumps({"corpus": "dataset_distill"})]
    assert publish_decoder.main(["--run", str(tmp / "port"), "--out", str(tmp / "pub_port"),
                                 "--device", "cpu", *meta]) == 0
    assert jax_script("publish_decoder").main(
        ["--run", str(tmp / "jax"), "--out", str(tmp / "pub_jax"), *meta]) == 0
    with np.load(tmp / "pub_port" / "latest.ckpt" / "params.npz") as f:
        assert {f[k].dtype for k in f.files} == {np.dtype(np.float16)}
    ours = load_params_only(tmp / "pub_port" / "latest.ckpt")
    assert_same_tree(ours, jax_params(tmp / "pub_jax" / "latest.ckpt", jconfig), np.float32)
    assert_same_tree(ours, jax.tree.map(lambda a: a.astype(np.float16).astype(np.float32),
                                        params))
    m_ours = json.loads((tmp / "pub_port" / "metadata.json").read_text())
    m_ref = json.loads((tmp / "pub_jax" / "metadata.json").read_text())
    assert m_ours.pop("source_run") == str(tmp / "port")
    assert m_ref.pop("source_run") == str(tmp / "jax")
    assert m_ours == m_ref == {"epochs": 2, "final_loss": 3.25, "train_tokens_per_sec": 1234.5,
                               "corpus": "dataset_distill"}
    for name in ("etude_decoder_config.json", "vocab.json"):
        assert (tmp / "pub_port" / name).read_bytes() == (tmp / "pub_jax" / name).read_bytes()
    load_etude_decoder(tmp / "pub_port" / "etude_decoder_config.json",
                       tmp / "pub_port" / "latest.ckpt", "cpu")


def test_publish_needs_a_finished_run(tmp_path):
    assert publish_decoder.main(["--run", str(tmp_path), "--out", str(tmp_path / "o"),
                                 "--device", "cpu"]) == 1


@pytest.mark.parametrize("script,argv", [
    (remap_decoder_warmstart, ["--run", "r", "--old-vocab", "a", "--new-vocab", "b",
                               "--out", "checkpoints/decoder_r4"]),
    (publish_decoder, ["--run", "r"]),
    (publish_decoder, ["--run", "r", "--out", "checkpoints/decoder"]),
    (run_separation, ["--input", "x.wav", "--output", "checkpoints/features.npy"]),
    (supervise_train, ["--ckpt-dir", "checkpoints/run", "--", "true"]),
], ids=["remap", "publish-default", "publish", "separation", "supervise"])
def test_scripts_refuse_checkpoints(script, argv, monkeypatch):
    """Nothing is written under checkpoints/; publish's default --out lies
    outside it and so gets past this check (and fails later: no run)."""
    monkeypatch.chdir(REPO)
    if argv == ["--run", "r"]:
        assert not Path(publish_decoder.DEFAULT_OUT).is_relative_to(REPO / "checkpoints")
        assert script.main([*argv, "--device", "cpu"]) == 1
        return
    with pytest.raises(ValueError, match="checkpoints/"):
        script.main(argv)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a GPU")
@pytest.mark.parametrize("script,argv", [
    (remap_decoder_warmstart, ["--run", "r", "--old-vocab", "a", "--new-vocab", "b",
                               "--out", "o"]),
    (dagger_rollouts, ["--run", "r", "--dataset-dir", "d"]),
], ids=["remap", "rollouts"])
def test_scripts_default_to_the_card(script, argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script.main(argv)


# ------------------------------------------------------------- run_separation
@pytest.mark.usefixtures("jax_f32_separator")
def test_run_separation_matches_jax(tmp_path):
    """The CLI of both packages on a 1 s tone, the committed separator's
    weights (the port reading them bridged into its own format)."""
    abstract = jax.eval_shape(lambda: jsep.init_params(jsep.SeparatorConfig(), seed=0))
    params = _np_tree(jax_training.load_params_only(CKPT, abstract, cache=False))
    save_aux_params(tmp_path / "separator", params)
    wav = tmp_path / "tone.wav"
    _tone_wav(wav, seconds=1.0)
    assert run_separation.main(["--input", str(wav), "--output", str(tmp_path / "port.npy"),
                                "--model", str(tmp_path / "separator"), "--device", "cpu"]) == 0
    assert jax_script("run_separation").main(
        ["--input", str(wav), "--output", str(tmp_path / "jax.npy"), "--model", str(CKPT)]) == 0
    ours, ref = np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy")
    assert ours.dtype == ref.dtype == np.float32 and ours.shape == ref.shape
    assert ours.shape[0] == 5 and ours.shape[2] == 128
    np.testing.assert_allclose(ours, ref, atol=DB_ATOL, rtol=0)


def test_run_separation_missing_input_and_model(tmp_path):
    assert run_separation.main(["--input", str(tmp_path / "none.wav"), "--output",
                                str(tmp_path / "o.npy"), "--device", "cpu"]) == 1
    wav = tmp_path / "tone.wav"
    _tone_wav(wav, seconds=0.2)
    with pytest.raises(FileNotFoundError):
        run_separation.main(["--input", str(wav), "--output", str(tmp_path / "o.npy"),
                             "--model", str(tmp_path / "missing"), "--device", "cpu"])


# ------------------------------------------------------------ supervise_train
CHILD = """
import os, subprocess, sys, time
log, mode = sys.argv[1], sys.argv[2]
with open(log, "a") as f:
    f.write(" ".join(sys.argv[3:]) + "\\n")
launches = len(open(log).read().splitlines())
if mode == "exit":
    sys.exit(int(sys.argv[3]))
if mode == "crash_once":
    sys.exit(1 if launches == 1 else 0)
if mode == "always_crash":
    sys.exit(1)
if mode == "stall_once":
    if "--resume" in sys.argv:
        sys.exit(0)
    grandchild = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    open(log + ".pid", "w").write(str(grandchild.pid))
    time.sleep(60)
"""


@pytest.fixture
def child(tmp_path, monkeypatch):
    monkeypatch.setattr(supervise_train, "SETTLE_SECONDS", 0.0)
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    log = tmp_path / "launches.log"

    def command(mode, *extra):
        return ["--", sys.executable, str(script), str(log), mode, *extra]

    def launches():
        return log.read_text().splitlines()

    return command, launches, tmp_path


def test_supervisor_passes_the_exit_code(child):
    command, launches, tmp = child
    assert supervise_train.main(["--ckpt-dir", str(tmp / "run"), *command("exit", "3")]) == 3
    assert launches() == ["3 --device cuda"]


def test_supervisor_restarts_a_stall_with_resume(child):
    command, launches, tmp = child
    (tmp / "run" / "latest").mkdir(parents=True)
    polls = []
    t = time.perf_counter()
    code = supervise_train.run(["--ckpt-dir", str(tmp / "run"), "--poll-seconds", "1",
                                "--stall-seconds", "2", "--device", "cpu",
                                *command("stall_once")],
                               on_poll=lambda burn, poll: polls.append(burn / poll))
    assert code == 0 and time.perf_counter() - t < 30
    assert launches() == ["--device cpu", f"--device cpu --resume {tmp / 'run'}"]
    assert len(polls) >= 2 and polls[-1] < 0.01
    pid = int((tmp / "launches.log.pid").read_text())
    time.sleep(0.2)
    state = Path(f"/proc/{pid}/stat")
    assert not state.exists() or state.read_text().split()[2] == "Z"   # the session died


def test_supervisor_restart_on_crash(child):
    command, launches, tmp = child
    argv = ["--ckpt-dir", str(tmp / "run"), "--device", "cpu"]
    assert supervise_train.main([*argv, *command("crash_once")]) == 1
    assert len(launches()) == 1
    (tmp / "launches.log").unlink()
    assert supervise_train.main([*argv, "--restart-on-crash", *command("crash_once")]) == 0
    # No `latest` yet: the restart gets no --resume.
    assert launches() == ["--device cpu", "--device cpu"]


def test_supervisor_restart_budget(child):
    command, launches, tmp = child
    (tmp / "run" / "latest").mkdir(parents=True)
    assert supervise_train.main(["--ckpt-dir", str(tmp / "run"), "--restart-on-crash",
                                 "--max-restarts", "2", "--device", "cpu",
                                 *command("always_crash")]) == 1
    assert launches() == ["--device cpu"] + [f"--device cpu --resume {tmp / 'run'}"] * 2


def test_supervisor_usage(capsys):
    assert supervise_train.main(["--ckpt-dir", "x"]) == 2


# ---------------------------------------------------------------------- entry
def test_entry_matches_jax():
    """The flagship forward: the example batch drawn as the JAX entry's,
    and the port's f32 logits on the CPU against the JAX `forward` at f32."""
    jfn, jargs = jax_entry.entry()
    fn, args = entry.entry("cpu")
    model, *tensors = args
    config = EtudeDecoderConfig()
    assert (config.vocab_size, config.hidden_size, config.num_hidden_layers) == (3000, 512, 8)
    for a, b in zip(tensors, jargs[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ours = fn(*args).numpy()
    params, ids, cls, mask, *attrs = jargs
    ref = np.asarray(jdec.forward(params, jdec.EtudeDecoderConfig(), jnp.asarray(ids),
                                  jnp.asarray(cls), dict(zip(jdec.ATTRIBUTE_ORDER, attrs)),
                                  jnp.asarray(mask), compute_dtype=jnp.float32))
    assert ours.shape == ref.shape == (2, 64, 3000) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=ENTRY_ATOL, rtol=0)
    batch = entry.example_batch(config)
    ref_batch = jax_entry._example_batch(jdec.EtudeDecoderConfig())
    assert batch.keys() == ref_batch.keys()
    for key in batch:
        np.testing.assert_array_equal(batch[key], ref_batch[key])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a GPU")
def test_entry_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()
