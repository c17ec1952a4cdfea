"""The port's attribute-prior training (etude_tpu_torch/models/attr_prior.py
`AttrPrior.fit`/`accuracy`/`save`, scripts/train_attr_prior.py) against the
JAX package's (etude_tpu/models/attr_prior.py:95-181,
scripts/train_attr_prior.py) on the same corpus songs.

Tolerances: both fits run in f64 from the same numpy draws (the port in
torch, batched over the four attributes) and store f32 weights; the f64
sums run in another order, so the weights are held to 1e-6 relative with a
1e-7 floor (f32 rounding of values of order 1; measured equal bit for bit
on these songs). The mean and std (f64 reductions cast to f32), the
accuracies and the script's meta.json are held equal.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from etude_tpu.data.dataset import EtudeDataset as JaxDataset
from etude_tpu.data.vocab import Vocab as JaxVocab
from etude_tpu.models.attr_prior import AttrPrior as JaxPrior
from etude_tpu_torch.data.dataset import EtudeDataset
from etude_tpu_torch.data.vocab import Vocab
from etude_tpu_torch.models.attr_prior import ATTR_NAMES, AttrPrior
from etude_tpu_torch.scripts import train_attr_prior
from test_torch_dataset import CORPUS, copy_songs

REPO = Path(__file__).resolve().parent.parent
WEIGHT_TOL = dict(rtol=1e-6, atol=1e-7)
SONGS = tuple(f"{i:04d}" for i in range(1, 21))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The fit is thousands of tiny batched matmuls: one thread is the
    fastest on a shared CPU. Restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_train_attr_prior", REPO / "scripts" / "train_attr_prior.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def features(tmp_path_factory):
    """The script's bar pairs over 20 corpus songs, with the edges of
    both packages' datasets (which must agree)."""
    root = copy_songs(tmp_path_factory.mktemp("prior") / "tokenized", SONGS)
    vocab = Vocab.load(CORPUS / "vocab.json")
    edges = EtudeDataset(root, vocab, max_seq_len=1024).attribute_bin_edges
    ref = JaxDataset(root, JaxVocab.load(CORPUS / "vocab.json"), max_seq_len=1024)
    assert edges.keys() == ref.attribute_bin_edges.keys()
    for k in edges:
        np.testing.assert_array_equal(edges[k], ref.attribute_bin_edges[k])
    X, y, song_ids, n = train_attr_prior.bar_pairs(root, vocab, edges)
    assert n == len(SONGS) and X.dtype == np.float64 and len(X) > 1000
    return X, y


def assert_priors_close(ours, ref):
    np.testing.assert_array_equal(ours.mean, ref.mean)
    np.testing.assert_array_equal(ours.std, ref.std)
    assert ours.mean.dtype == ref.mean.dtype == np.float32
    assert ours.weights.keys() == ref.weights.keys()
    for name in ref.weights:
        assert ours.weights[name].dtype == np.float32
        np.testing.assert_allclose(ours.weights[name], ref.weights[name], **WEIGHT_TOL)


@pytest.mark.parametrize("seed", [0, 7])
def test_fit_matches_jax(features, seed):
    X, y = features
    ours = AttrPrior.fit(X, y, steps=200, seed=seed, device="cpu")
    ref = JaxPrior.fit(X, y, steps=200, seed=seed)
    assert_priors_close(ours, ref)
    assert ours.accuracy(X, y) == ref.accuracy(X, y)
    # The fit learns: each attribute beats its initial (seed-only) weights.
    start = AttrPrior.fit(X, y, steps=0, seed=seed, device="cpu").accuracy(X, y)
    assert sum(ours.accuracy(X, y).values()) > sum(start.values())


def test_seed_moves_the_weights(features):
    """The control of the test above: another seed's start gives other
    weights."""
    X, y = features
    a = AttrPrior.fit(X, y, steps=20, seed=0, device="cpu")
    b = AttrPrior.fit(X, y, steps=20, seed=1, device="cpu")
    assert not np.allclose(a.weights[ATTR_NAMES[0]], b.weights[ATTR_NAMES[0]], **WEIGHT_TOL)


def test_each_package_loads_the_others_save(features, tmp_path):
    X, y = features
    ours = AttrPrior.fit(X, y, steps=50, seed=0, device="cpu")
    ref = JaxPrior.fit(X, y, steps=50, seed=0)
    ours.save(tmp_path / "port", meta={"steps": 50})
    ref.save(tmp_path / "jax", meta={"steps": 50})
    assert sorted(np.load(tmp_path / "port" / "weights.npz").files) == \
        sorted(np.load(tmp_path / "jax" / "weights.npz").files)
    assert json.loads((tmp_path / "port" / "meta.json").read_text()) == {"steps": 50}
    assert_priors_close(JaxPrior.load(tmp_path / "port"), ref)
    assert_priors_close(AttrPrior.load(tmp_path / "jax"), ours)
    vocab = Vocab.load(CORPUS / "vocab.json")
    bars = [[vocab.bar_bos_id, vocab.bar_eos_id]] * 3
    assert (AttrPrior.load(tmp_path / "jax").predict_bins(bars, vocab)
            == JaxPrior.load(tmp_path / "port").predict_bins(bars, JaxVocab.load(CORPUS / "vocab.json")))


def test_script_matches_jax(tmp_path):
    """scripts/train_attr_prior.py of both packages on a copy of 12 songs:
    equal meta.json, close weights."""
    dataset = tmp_path / "dataset"
    copy_songs(dataset / "tokenized", SONGS[:12])
    (dataset / "vocab.json").write_bytes((CORPUS / "vocab.json").read_bytes())
    common = ["--dataset", str(dataset), "--steps", "300", "--seed", "3"]
    run = train_attr_prior.run([*common, "--out", str(tmp_path / "port"), "--device", "cpu"])
    assert jax_script().main([*common, "--out", str(tmp_path / "jax")]) == 0
    ref_meta = json.loads((tmp_path / "jax" / "meta.json").read_text())
    assert json.loads((tmp_path / "port" / "meta.json").read_text()) == ref_meta == run.meta
    assert ref_meta["songs"] == 12 and ref_meta["eval_songs"] == 1
    assert_priors_close(AttrPrior.load(tmp_path / "port"), JaxPrior.load(tmp_path / "jax"))


def test_script_refuses_checkpoints_and_needs_a_device(tmp_path):
    with pytest.raises(ValueError, match="checkpoints/"):
        train_attr_prior.main(["--out", str(REPO / "checkpoints" / "attr_prior")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_attr_prior.main(["--out", str(tmp_path / "x")])
