"""The separator features of the corpus paths, through the committed
separator checkpoint (read through orbax here), in the port against the JAX
package in f32 on the CPU: `train_aux beat-corpus`'s feature cache
(`prepare_beat_feature_cache`) and the corpus-piano beat scenes
(scripts/gen_beat_scenes.py `make_scene`), on a synthetic corpus
(etude_tpu_torch/tools/synthetic_corpus.py).

Both sides store f16; the f32 features each side computed before that
(recorded at `separate_features`) are held to the feature tolerance of
tests/test_torch_separation.py, DB_ATOL = 1e-2 dB. The rest of each file
(grid beat and downbeat times, bpm, labels, tempo class) is bit-equal, and
each side's f16 is its own f32 rounded.
"""

import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import etude_tpu.data.separation as jax_sep
from etude_tpu.models import separator as jsep
from etude_tpu.utils.training import load_params_only
from etude_tpu_torch import train_aux
from etude_tpu_torch.data import corpus_render as cr
from etude_tpu_torch.data.separation import SourceSeparator
from etude_tpu_torch.scripts import gen_beat_scenes
from etude_tpu_torch.tools.synthetic_corpus import write_corpus

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import gen_beat_scenes as jax_scenes  # noqa: E402

CKPT = REPO / "checkpoints" / "separator" / "latest.ckpt"
DB_ATOL = 1e-2


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


@pytest.fixture(scope="module")
def committed_params():
    abstract = jax.eval_shape(lambda: jsep.init_params(jsep.SeparatorConfig(), seed=0))
    return jax.tree.map(np.asarray, load_params_only(CKPT, abstract))


@pytest.fixture
def jax_f32_separator(monkeypatch):
    """The JAX SourceSeparator with its U-Net in f32 (its production call
    runs the bf16 default), its jit cache cleared before and after."""
    monkeypatch.setattr(jax_sep, "forward",
                        functools.partial(jsep.forward, compute_dtype=jnp.float32))
    jax_sep._separate_mel_jit.clear_cache()
    yield
    jax_sep._separate_mel_jit.clear_cache()


def recording(separator):
    """`separator` whose `separate_features` results are kept in `.seen`
    (as f32 numpy)."""
    separator.seen = []
    features = separator.separate_features

    def record(*args, **kw):
        out = features(*args, **kw)
        separator.seen.append(np.asarray(out, np.float32))
        return out

    separator.separate_features = record
    return separator


def test_beat_corpus_cache_matches_jax(tmp_path, corpus, script, committed_params,
                                       jax_f32_separator, monkeypatch):
    """One train song's etude_d through both caches: the JAX one reads the
    committed checkpoint itself, the port's is handed the same weights."""
    song = cr.split_songs(cr.corpus_song_dirs(corpus))[0][0]
    seen = []
    features = jax_sep.SourceSeparator.separate_features

    def record(self, *args, **kw):
        out = features(self, *args, **kw)
        seen.append(np.asarray(out, np.float32))
        return out

    monkeypatch.setattr(jax_sep.SourceSeparator, "separate_features", record)
    ref = script.prepare_beat_feature_cache([song], tmp_path / "jax", seconds=90.0,
                                            snap_gate=0.02, versions=("etude_d",))
    port_sep = recording(SourceSeparator(params=committed_params, device="cpu"))
    entries = train_aux.prepare_beat_feature_cache(
        [song], tmp_path / "port", seconds=90.0, snap_gate=0.02,
        separator=lambda: port_sep, versions=("etude_d",))
    assert [p.name for p in entries] == [p.name for p in ref] == [f"{song.name}_etude_d.npz"]
    assert not list((tmp_path / "port").glob("*.wav"))
    (ours,), (theirs,) = port_sep.seen, seen
    assert ours.shape == theirs.shape and ours.shape[0] == 5 and ours.shape[2] == 128
    np.testing.assert_allclose(ours, theirs, atol=DB_ATOL, rtol=0)
    with np.load(entries[0]) as a, np.load(ref[0]) as b:
        assert sorted(a.files) == sorted(b.files) == ["beat_times", "bpm", "downbeat_times",
                                                      "features"]
        for key in ("beat_times", "downbeat_times", "bpm"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert a["features"].dtype == b["features"].dtype == np.float16
        np.testing.assert_array_equal(a["features"], ours.astype(np.float16))
    # A second call reuses the entry without the separator.
    again = train_aux.prepare_beat_feature_cache(
        [song], tmp_path / "port", seconds=90.0, snap_gate=0.02,
        separator=lambda: pytest.fail("the cache was recomputed"), versions=("etude_d",))
    assert again == entries


def test_beat_scene_matches_jax(corpus, committed_params, jax_f32_separator):
    """gen_beat_scenes `make_scene` from the same generator and pool: the
    same window, augmentation and labels, the features within DB_ATOL."""
    train, _ = cr.split_songs(cr.corpus_song_dirs(corpus))
    pool = gen_beat_scenes.snap_gated_pool(train, 0.02)
    port_sep = recording(SourceSeparator(params=committed_params, device="cpu"))
    jax_separator = recording(jax_sep.SourceSeparator(params=committed_params))
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    scene = ref = None
    for _ in range(6):           # the first usable window
        scene = gen_beat_scenes.make_scene(r1, pool, port_sep)
        ref = jax_scenes.make_scene(r2, pool, jax_separator)
        assert (scene is None) == (ref is None)
        if scene is not None:
            break
    assert scene is not None
    x, act, tempo = scene
    assert x.shape == ref[0].shape == (5, 512, 128) and x.dtype == ref[0].dtype == np.float16
    (ours,), (theirs,) = port_sep.seen, jax_separator.seen
    np.testing.assert_allclose(ours, theirs, atol=DB_ATOL, rtol=0)
    cut = np.pad(ours, ((0, 0), (0, max(0, 512 - ours.shape[1])), (0, 0)),
                 constant_values=-80.0)[:, :512]
    np.testing.assert_array_equal(x, cut.astype(np.float16))
    for a, b in ((act, ref[1]), (tempo, ref[2])):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
