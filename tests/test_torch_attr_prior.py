"""The port's attribute prior (etude_tpu_torch/models/attr_prior.py) against
the JAX package's (etude_tpu/models/attr_prior.py) on the committed
predictor (checkpoints/attr_prior/weights.npz) and corpus source bars.

Both are the same numpy arithmetic on the same inputs: features,
probabilities and bins must be equal, at temperature 0 (argmax) and above
0 (numpy's generator from the same seed).
"""

from pathlib import Path

import numpy as np
import pytest

from etude_tpu.data.dataset import extract_bar_features as jax_bar_features
from etude_tpu.data.vocab import Vocab as JaxVocab
from etude_tpu.models import attr_prior as jap
from etude_tpu_torch.data.dataset import extract_bar_features
from etude_tpu_torch.data.tokenizer import split_sequence_into_bars
from etude_tpu_torch.data.vocab import Vocab
from etude_tpu_torch.models import attr_prior as ap

REPO = Path(__file__).resolve().parent.parent
PRIOR = REPO / "checkpoints" / "attr_prior"
VOCAB = REPO / "checkpoints" / "decoder" / "vocab.json"


def _song_bars(song: str, vocab):
    ids = np.load(REPO / "dataset_distill" / "tokenized" / song / f"{song}_src.npy").tolist()
    return split_sequence_into_bars(ids, vocab.bar_bos_id, vocab.bar_eos_id)


@pytest.fixture(scope="module")
def priors():
    return ap.AttrPrior.load(PRIOR), jap.AttrPrior.load(PRIOR)


@pytest.mark.parametrize("song", ["0001", "0002"])
def test_bar_features_equal_jax(song):
    vocab, jvocab = Vocab.load(VOCAB), JaxVocab.load(VOCAB)
    bars = _song_bars(song, vocab) + [[vocab.bar_bos_id, vocab.bar_eos_id]]
    for i, bar in enumerate(bars):
        ours = ap.bar_feature_vector(extract_bar_features(bar, vocab), i, len(bars))
        ref = jap.bar_feature_vector(jax_bar_features(bar, jvocab), i, len(bars))
        assert ours.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(ours, ref)


def test_loaded_weights_and_probs_equal_jax(priors):
    ours, ref = priors
    assert set(ours.weights) == set(ref.weights) == set(ap.ATTR_NAMES)
    for name in ap.ATTR_NAMES:
        np.testing.assert_array_equal(ours.weights[name], ref.weights[name])
    np.testing.assert_array_equal(ours.mean, ref.mean)
    np.testing.assert_array_equal(ours.std, ref.std)
    X = np.random.default_rng(0).normal(size=(40, ap.N_FEATURES)).astype(np.float32)
    p_ours, p_ref = ours.probs(X), ref.probs(X)
    for name in ap.ATTR_NAMES:
        np.testing.assert_array_equal(p_ours[name], p_ref[name])


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.7, 3), (1.5, 11)])
@pytest.mark.parametrize("song", ["0001", "0003"])
def test_predict_bins_equal_jax(priors, song, temperature, seed):
    ours, ref = priors
    vocab, jvocab = Vocab.load(VOCAB), JaxVocab.load(VOCAB)
    bars = _song_bars(song, vocab)
    got = ours.predict_bins(bars, vocab, temperature=temperature, seed=seed)
    want = ref.predict_bins(bars, jvocab, temperature=temperature, seed=seed)
    assert got == want
    assert len(got) == len(bars)
    assert all(set(a) == set(ap.NAME_TO_KEY.values()) and all(0 <= v < 3 for v in a.values())
               for a in got)
    if temperature == 0.0:  # the committed predictor does not answer one constant
        assert len({tuple(sorted(a.items())) for a in got}) > 1
