"""The port's vocabulary surgery (etude_tpu_torch/utils/model_loader.py
`remap_decoder_vocab`, `_nearest_token_id`) against the JAX package's
(etude_tpu/utils/model_loader.py:16-69) on the same numpy trees.

Tolerance: none. Both copy rows and columns of the same arrays, so the
results are equal bit for bit, dtype included.
"""

import io
from pathlib import Path

import numpy as np
import pytest

from etude_tpu.data.vocab import Vocab as JaxVocab
from etude_tpu.models.decoder import EtudeDecoderConfig as JaxConfig
from etude_tpu.models.decoder import init_params
from etude_tpu.utils import model_loader as jax_loader
from etude_tpu_torch.data.vocab import Vocab
from etude_tpu_torch.utils import model_loader

REPO = Path(__file__).resolve().parent.parent
OLD_VOCAB, NEW_VOCAB = REPO / "dataset_distill/vocab.json", REPO / "dataset_distill_r4/vocab.json"
TINY = dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
            intermediate_size=32, attribute_emb_dim=4)


def toy_vocabs(cls):
    """tests/test_train.py's pair: a shuffled rebuild with one unseen token."""
    old, new = cls(), cls()
    for tok in ["Bar_BOS", "Bar_EOS", "Note_60", "Note_62", "Duration_4"]:
        old.add(tok)
    for tok in ["Bar_BOS", "Bar_EOS", "Duration_4", "Note_60", "Note_61", "Note_62"]:
        new.add(tok)
    return old, new


def toy_params(V, H=8, dtype=np.float32):
    rng = np.random.default_rng(0)
    return {"word_emb": rng.normal(size=(V, H)).astype(dtype),
            "lm_head": rng.normal(size=(H, V)).astype(dtype),
            "final_ln": {"scale": np.ones(H, dtype)}}


def committed_params(dtype):
    config = JaxConfig(vocab_size=len(Vocab.load(OLD_VOCAB)), **TINY)
    tree = init_params(config, seed=3)
    return {"word_emb": np.asarray(tree["word_emb"]).astype(dtype),
            "lm_head": np.asarray(tree["lm_head"]).astype(dtype),
            "final_ln": {k: np.asarray(v) for k, v in tree["final_ln"].items()}}


def assert_trees_equal(ours, ref):
    assert ours.keys() == ref.keys()
    for key in ("word_emb", "lm_head"):
        assert ours[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(ours[key], ref[key])
    assert ours["final_ln"] is ref["final_ln"] or ours["final_ln"] == ref["final_ln"]


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_toy_remap_equals_jax(dtype):
    ours_old, ours_new = toy_vocabs(Vocab)
    ref_old, ref_new = toy_vocabs(JaxVocab)
    params = toy_params(len(ours_old), dtype=dtype)
    ours = model_loader.remap_decoder_vocab(params, ours_old, ours_new)
    ref = jax_loader.remap_decoder_vocab(params, ref_old, ref_new)
    assert_trees_equal(ours, ref)
    assert ours["word_emb"].shape == (len(ours_new), 8)
    assert ours["lm_head"].shape == (8, len(ours_new))


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_committed_remap_equals_jax(dtype):
    """dataset_distill (116 tokens) → dataset_distill_r4 (119)."""
    ours_old, ours_new = Vocab.load(OLD_VOCAB), Vocab.load(NEW_VOCAB)
    assert (len(ours_old), len(ours_new)) == (116, 119)
    params = committed_params(dtype)
    ours = model_loader.remap_decoder_vocab(params, ours_old, ours_new)
    ref = jax_loader.remap_decoder_vocab(params, JaxVocab.load(OLD_VOCAB),
                                         JaxVocab.load(NEW_VOCAB))
    assert_trees_equal(ours, ref)


def test_new_notes_borrow_note_102(monkeypatch):
    """Note_103-Note_105 exist only in the rebuilt vocabulary; each takes
    Note_102's row and column, and the log line names them."""
    old, new = Vocab.load(OLD_VOCAB), Vocab.load(NEW_VOCAB)
    params = committed_params(np.float32)
    log = io.StringIO()
    monkeypatch.setattr(model_loader.logger, "stream", log)
    out = model_loader.remap_decoder_vocab(params, old, new)
    src = old.token_to_id["Note_102"]
    added = sorted(set(new.token_to_id) - set(old.token_to_id))
    assert added == ["Note_103", "Note_104", "Note_105"]
    for tok in added:
        nid = new.token_to_id[tok]
        np.testing.assert_array_equal(out["word_emb"][nid], params["word_emb"][src])
        np.testing.assert_array_equal(out["lm_head"][:, nid], params["lm_head"][:, src])
    err = log.getvalue()
    assert "vocab remap: borrowed weights for" in err
    for tok in added:
        assert f"{tok}←id{src}" in err


@pytest.mark.parametrize("which", ["toy", "committed"])
def test_nearest_token_id_equals_jax(which):
    old, new = toy_vocabs(Vocab) if which == "toy" else (Vocab.load(OLD_VOCAB),
                                                          Vocab.load(NEW_VOCAB))
    old_map = dict(old.token_to_id)
    for tok in list(new.token_to_id) + ["Note_-3", "Velocity_200", "NoUnderscore"]:
        assert (model_loader._nearest_token_id(tok, old_map)
                == jax_loader._nearest_token_id(tok, old_map)), tok
