"""The port's training dataset (etude_tpu_torch/data/dataset.py) against the
JAX package's (etude_tpu/data/dataset.py) on three corpus songs with their
DAgger rollouts: the same songs, bin edges, sample map and, for the same
seed, the same batches bit for bit (exact equality throughout)."""

import shutil
from pathlib import Path

import numpy as np
import pytest

from etude_tpu.data.dataset import EtudeDataset as JaxDataset
from etude_tpu.data.vocab import Vocab as JaxVocab
from etude_tpu_torch.data.dataset import EtudeDataset
from etude_tpu_torch.data.vocab import Vocab

REPO = Path(__file__).resolve().parent.parent
CORPUS = REPO / "dataset_distill"
SONGS = ("0001", "0002", "0003")


def copy_songs(dst: Path, songs=SONGS) -> Path:
    """The named songs of dataset_distill/tokenized (src, tgt and _hist
    rollouts) copied under `dst`."""
    for song in songs:
        shutil.copytree(CORPUS / "tokenized" / song, dst / song)
    return dst


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = copy_songs(tmp_path_factory.mktemp("tokenized"))
    kw = dict(max_seq_len=128, hist_suffix="_hist.npy", attr_dropout=0.3,
              dagger_history_prob=0.5)
    ours = EtudeDataset(root, Vocab.load(CORPUS / "vocab.json"), **kw)
    ref = JaxDataset(root, JaxVocab.load(CORPUS / "vocab.json"), **kw)
    return ours, ref


def test_songs_bins_and_sample_map_equal(datasets):
    ours, ref = datasets
    assert len(ours.songs) == len(SONGS)
    assert ours.songs == ref.songs
    assert any(b["hist_bar_ids"] != b["tgt_bar_ids"]
               for s in ours.songs for b in s["bars"])
    assert ours.attribute_bin_edges.keys() == ref.attribute_bin_edges.keys()
    for name, edges in ref.attribute_bin_edges.items():
        np.testing.assert_array_equal(ours.attribute_bin_edges[name], edges)
    assert ours.sample_map == ref.sample_map
    assert ours[5] == ref[5]


@pytest.mark.parametrize("seed", [0, 1234])
@pytest.mark.parametrize("drop_last", [True, False])
def test_batches_bit_equal(datasets, seed, drop_last):
    ours, ref = datasets
    # 8 does not divide the chunk count, so the last batch is partial.
    assert len(ours) % 8
    got = list(ours.batches(8, shuffle=True, seed=seed, drop_last=drop_last))
    want = list(ref.batches(8, shuffle=True, seed=seed, drop_last=drop_last))
    assert len(got) == len(want) == len(ours) // 8 + (not drop_last)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in b:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
