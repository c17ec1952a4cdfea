"""The corpus modes' training batches in the port (etude_tpu_torch/
train_aux.py: `amt-corpus`, `beat-corpus`, `beat --scenes-dir`, `separator
--pseudopop-cache/--pseudopop-mix`) against the JAX script's
(scripts/train_aux_synthetic.py), bit for bit, on a synthetic corpus
(etude_tpu_torch/tools/synthetic_corpus.py).

The JAX script's batch generators are closures inside its `run_*`
functions: they are captured by patching the script module's `train_loop`
(which the run calls with the generator, and which here stops the run),
with the JAX `corpus_render.corpus_song_dirs` pointed at the synthetic
corpus and its resampler on its native path, the same kernel as the port's
(tests/test_torch_corpus_data.py says why). The port's tasks are built at narrow widths: the batches depend
only on the data settings. Steps are generated one after another in one
thread on both sides; the corpus modes' generators are seeded by (seed,
step), the others share one generator, as their prefetch threads do.
"""

import argparse
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import etude_tpu.data.corpus_render as jax_cr
import etude_tpu.native as jax_native
from etude_tpu_torch import train_aux
from etude_tpu_torch.data import corpus_render as cr, separation
from etude_tpu_torch.models import amt, beat_transformer as bt, separator as sep
from etude_tpu_torch.tools.synthetic_corpus import write_corpus
from etude_tpu_torch.utils.training import save_aux_params
from etude_tpu_torch.weights import init_amt_params_np

REPO = Path(__file__).resolve().parent.parent
BEAT = bt.BeatTransformerConfig(dmodel=32, nhead=8, d_hid=64, nlayers=3)
SEPARATOR = sep.SeparatorConfig(base_channels=2, depth=2)
# The hFT's data settings (n_frame, margins) stay published: they shape
# the batch.
AMT = amt.AMTConfig(hid_dim=16, pf_dim=32, encoder_n_layer=1, decoder_n_layer=1,
                    encoder_n_head=2, decoder_n_head=2)


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads: these models are narrow, and a CPU shared by
    several test workers loses more to contending threads than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class Captured(Exception):
    """Raised by the patched `train_loop` once it holds the generator."""


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("songs")
    write_corpus(root, n_songs=6, seconds=(20.0, 30.0), seed=0)
    return root


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "train_aux_synthetic", REPO / "scripts" / "train_aux_synthetic.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def on_corpus(corpus, monkeypatch):
    """Both packages read the synthetic corpus; the JAX resampler runs its
    native kernel (no silent scipy fallback)."""
    monkeypatch.setattr(cr, "CORPUS_ROOT", corpus)
    songs = jax_cr.corpus_song_dirs
    monkeypatch.setattr(jax_cr, "corpus_song_dirs", lambda root=corpus: songs(root))
    assert jax_native.load_resample_library() is not None
    return corpus


@pytest.fixture
def jax_gen(script, monkeypatch):
    """jax_gen(run, args) → (the generator the JAX run trains on, its
    prefetch workers)."""
    box = {}

    def train_loop(name, params, loss_fn, gen_fn, steps, lr, log_every=50, workers=1):
        box.update(gen=gen_fn, workers=workers)
        raise Captured

    monkeypatch.setattr(script, "train_loop", train_loop)

    def capture(run, args):
        with pytest.raises(Captured):
            run(args)
        return box["gen"], box["workers"]

    return capture


def cli_args(mode, tmp_path, *extra):
    args = train_aux.parse_args([mode, "--device", "cpu", "--output-dir", str(tmp_path / "out"),
                                 *extra])
    batch, lr = train_aux.DEFAULTS[mode]
    args.batch = args.batch or batch
    args.lr = args.lr or lr
    args.output_dir = tmp_path / "out"
    return args


def port_task(mode, args, **kw):
    return train_aux.TASKS[mode](args, torch.device("cpu"), **kw)


def same_batch(a, b):
    assert list(a) == list(b)
    for key in a:
        if isinstance(a[key], dict):
            assert a[key].keys() == b[key].keys()
            for k in a[key]:
                assert type(a[key][k]) is type(b[key][k]) and a[key][k] == b[key][k], key
        else:
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("warm", [False, True], ids=["scratch", "warm"])
def test_amt_corpus_batches_equal_jax(tmp_path, on_corpus, script, jax_gen, warm):
    """Step i of `amt-corpus` from the same seed; a warm start (the JAX run
    from the committed extractor, the port from an export of its own) keeps
    the positive weights at 1, a cold one anneals them from 120 and 3."""
    init = tmp_path / "init" / "latest"
    if warm:
        save_aux_params(init, init_amt_params_np(AMT, seed=1))
    args = cli_args("amt-corpus", tmp_path, "--steps", "10", "--batch", "2", "--seed", "3",
                    "--init-from", str(init) if warm else str(tmp_path / "missing"))
    task = port_task("amt-corpus", args, config=AMT)
    jax_args = argparse.Namespace(**vars(args))
    if warm:
        jax_args.init_from = None    # the script's default: the committed checkpoint
        assert (REPO / "checkpoints" / "extractor" / "latest.ckpt").exists()
    gen, workers = jax_gen(script.run_amt_corpus, jax_args)
    assert task.workers == workers == 3
    for i in (0, 2):
        port, ref = task.gen(i), gen(i)
        same_batch(port, ref)
        assert float(port["pos_w"]["onset"]) == pytest.approx(
            1.0 if warm else 1.0 + 119.0 * (1 - i / 3), rel=1e-6)


def test_beat_corpus_batches_equal_jax(tmp_path, on_corpus, script, jax_gen, monkeypatch):
    """`beat-corpus` step i, the port and the JAX run reading the same cache
    files (the port's, made with a narrow separator)."""
    args = cli_args("beat-corpus", tmp_path, "--steps", "4", "--batch", "6", "--seed", "2",
                    "--beat-frames", "96", "--corpus-limit", "2", "--eval-seconds", "30")
    monkeypatch.setattr(separation, "SeparatorConfig", lambda: SEPARATOR)
    task = port_task("beat-corpus", args, config=BEAT)
    entries = sorted((tmp_path / "out" / "beat_corpus_cache").glob("*.npz"))
    assert [p.name for p in entries] == ["CPOP02_etude_d.npz", "CPOP02_etude_d_d.npz",
                                         "CPOP03_etude_d.npz", "CPOP03_etude_d_d.npz"]
    seen = {}

    def cached(song_dirs, cache_dir, seconds, snap_gate, versions=("etude_d", "etude_d_d")):
        seen.update(songs=[d.name for d in song_dirs], seconds=seconds, gate=snap_gate)
        return entries

    monkeypatch.setattr(script, "prepare_beat_feature_cache", cached)
    gen, workers = jax_gen(script.run_beat_corpus, argparse.Namespace(**vars(args)))
    assert seen == {"songs": ["CPOP02", "CPOP03"], "seconds": 90.0, "gate": 0.02}
    assert task.workers == workers == 2
    for i in (0, 1, 3):
        same_batch(task.gen(i), gen(i))


def _scene_shards(root: Path, n=(5, 3), seed=0):
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    for k, m in enumerate(n):
        np.savez_compressed(root / f"shard_{k:04d}.npz",
                            x=rng.uniform(-80, 0, (m, 5, 512, 128)).astype(np.float16),
                            activations=rng.uniform(0, 1, (m, 512, 2)).astype(np.float16),
                            tempo=rng.integers(0, 300, m).astype(np.int32))


def test_beat_scenes_rows_equal_jax(tmp_path, on_corpus, script, jax_gen):
    """`beat --scenes-dir`: the shards' rows mixed into the procedural
    scenes, one thread on both sides."""
    _scene_shards(tmp_path / "scenes")
    args = cli_args("beat", tmp_path, "--steps", "3", "--batch", "4", "--beat-frames", "64",
                    "--scenes-dir", str(tmp_path / "scenes"), "--corpus-mix", "0.5")
    task = port_task("beat", args, config=BEAT)
    gen, workers = jax_gen(script.run_beat, argparse.Namespace(**vars(args)))
    assert task.workers == workers == 3
    for i in range(3):
        same_batch(task.gen(i), gen(i))


@pytest.mark.parametrize("cached", [True, False], ids=["cache", "on-the-fly"])
def test_separator_pseudopop_rows_equal_jax(tmp_path, on_corpus, script, jax_gen, cached):
    """`separator --pseudopop-mix 0.5`: the cache's rows, or rows rendered on
    the fly from the train split's grids, then the RMS normalisation."""
    extra = ["--pseudopop-mix", "0.5"]
    if cached:
        rng = np.random.default_rng(4)
        (tmp_path / "pp").mkdir()
        np.savez_compressed(tmp_path / "pp" / "shard_0000.npz",
                            mix_mag=rng.uniform(0, 3, (6, 256, 2049)).astype(np.float16),
                            stem_mags=rng.uniform(0, 1, (6, 5, 256, 2049)).astype(np.float16))
        extra += ["--pseudopop-cache", str(tmp_path / "pp")]
    args = cli_args("separator", tmp_path, "--steps", "2", "--batch", "2", "--seed", "5", *extra)
    task = port_task("separator", args, config=SEPARATOR)
    gen, workers = jax_gen(script.run_separator, argparse.Namespace(**vars(args)))
    assert task.workers == workers == 1
    for i in range(2):
        same_batch(task.gen(i), gen(i))


def test_separator_pseudopop_needs_a_pool(tmp_path, monkeypatch):
    """A pseudo-pop share with no snap-gated train song raises instead of
    training on the synthetic stems alone."""
    monkeypatch.setattr(cr, "CORPUS_ROOT", tmp_path / "empty")
    args = cli_args("separator", tmp_path, "--pseudopop-mix", "0.5")
    with pytest.raises(RuntimeError, match="snap gate"):
        port_task("separator", args, config=SEPARATOR)


def test_beat_corpus_needs_cached_songs(tmp_path, monkeypatch):
    monkeypatch.setattr(cr, "CORPUS_ROOT", tmp_path / "empty")
    args = cli_args("beat-corpus", tmp_path)
    with pytest.raises(RuntimeError, match="snap gate"):
        port_task("beat-corpus", args, config=BEAT)


def test_pseudopop_windows_too_short_raise(tmp_path, on_corpus, monkeypatch):
    """A window that cannot hold ten beats never passes sample_window: the
    port gives up after a bounded number of draws."""
    args = cli_args("separator", tmp_path, "--pseudopop-mix", "0.5", "--sep-frames", "16",
                    "--batch", "2")
    task = port_task("separator", args, config=SEPARATOR)
    monkeypatch.setattr(train_aux, "PSEUDOPOP_DRAWS", 20)
    with pytest.raises(RuntimeError, match="pseudo-pop window"):
        task.gen(0)
