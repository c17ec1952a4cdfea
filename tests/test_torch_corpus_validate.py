"""The full-chain evaluations of the corpus scripts through the committed
separator and beat checkpoints (read through orbax here), in the port
against the JAX package in f32 on the CPU, on a synthetic corpus
(etude_tpu_torch/tools/synthetic_corpus.py):

- scripts/validate_beat_corpus.py `validate` on one held-out song (render →
  separator → Beat-Transformer → DBN): the same summary, per-song `beat_f`
  and `beat_f_octave` included;
- scripts/eval_separator_pseudopop.py's mel magnitudes of a pseudo-pop mix,
  of the mix path (`mel_mag`) and of the separator's stems: within the
  feature tolerance of tests/test_torch_separation.py, DB_ATOL = 1e-2 dB,
  on the features' dB scale (power_to_db, 80 dB floor below each peak).
"""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import etude_tpu.data.beat_detector as jax_bd
import etude_tpu.data.separation as jax_sep
from etude_tpu.config.schema import BeatDetectorConfig as JaxBeatDetectorConfig
from etude_tpu.models import beat_transformer as jbt
from etude_tpu.models import separator as jsep
from etude_tpu.utils.training import load_params_only
from etude_tpu_torch.config import BeatDetectorConfig
from etude_tpu_torch.data import corpus_render as cr
from etude_tpu_torch.data.beat_detector import BeatDetector
from etude_tpu_torch.data.separation import SourceSeparator, power_to_db
from etude_tpu_torch.scripts import eval_separator_pseudopop, validate_beat_corpus
from etude_tpu_torch.tools.synthetic_corpus import write_corpus

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import eval_separator_pseudopop as jax_eval  # noqa: E402
import validate_beat_corpus as jax_validate  # noqa: E402

DB_ATOL = 1e-2


def _committed(module, name):
    abstract = jax.eval_shape(lambda: module.init_params(
        {"separator": jsep.SeparatorConfig, "beat_detector": jbt.BeatTransformerConfig}[name](),
        seed=0))
    return jax.tree.map(np.asarray, load_params_only(
        REPO / "checkpoints" / name / "latest.ckpt", abstract))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("songs")
    write_corpus(root, n_songs=6, seconds=(20.0, 30.0), seed=0)
    return root


@pytest.fixture(scope="module")
def separator_params():
    return _committed(jsep, "separator")


@pytest.fixture(scope="module")
def beat_params():
    return _committed(jbt, "beat_detector")


@pytest.fixture
def jax_f32(monkeypatch):
    """The JAX separator and beat model in f32 (their production calls run
    the bf16 default), their jit caches cleared before and after."""
    monkeypatch.setattr(jax_sep, "forward",
                        functools.partial(jsep.forward, compute_dtype=jnp.float32))
    monkeypatch.setattr(jax_bd, "forward",
                        functools.partial(jbt.forward, compute_dtype=jnp.float32))
    caches = (jax_sep._separate_mel_jit, jax_bd._beat_activations_jit)
    for jitted in caches:
        jitted.clear_cache()
    yield
    for jitted in caches:
        jitted.clear_cache()


def test_validate_matches_jax(tmp_path, corpus, separator_params, beat_params, jax_f32,
                              monkeypatch):
    # The JAX score_song renders to a fixed path by default: give it this
    # test's own.
    monkeypatch.setattr(jax_validate.score_song, "__defaults__", (tmp_path / "jax.wav",))
    _, held_out = cr.split_songs(cr.corpus_song_dirs(corpus))
    songs = held_out[:1]
    ref = jax_validate.validate(jax_sep.SourceSeparator(params=separator_params),
                                jax_bd.BeatDetector(JaxBeatDetectorConfig(), params=beat_params),
                                songs, n_songs=1, seconds=30.0, snap_gate=0.02)
    out = validate_beat_corpus.validate(
        SourceSeparator(params=separator_params, device="cpu"),
        BeatDetector(BeatDetectorConfig(), params=beat_params, device="cpu"),
        songs, n_songs=1, seconds=30.0, snap_gate=0.02)
    assert out == ref
    row, = out["songs"]
    assert row["song"] == "CPOP01" and row["n_ref"] >= 8 and out["snap_gated_out"] == 0
    assert 0.0 <= row["beat_f"] <= row["beat_f_octave"] <= 1.0


def test_pseudopop_mel_magnitudes_match_jax(corpus, separator_params, jax_f32):
    _, held_out = cr.split_songs(cr.corpus_song_dirs(corpus))
    gated = validate_beat_corpus.snap_gated_song(held_out[1] / "etude_d.mid", 10.0, 0.02)
    assert gated is not None
    notes, tempo, _snap = gated
    mix, stems, beats = eval_separator_pseudopop.build_stems(notes, tempo, 8.0, 44100, seed=0)
    ref = jax_eval.build_stems(notes, tempo, 8.0, 44100, seed=0)
    np.testing.assert_array_equal(mix, ref[0])
    np.testing.assert_array_equal(beats, ref[2])

    def db(mag):
        return power_to_db(np.square(mag.astype(np.float64)))

    for wave in (mix, stems["drums"], stems["vocals"]):
        ours, theirs = eval_separator_pseudopop.mel_mag(wave), jax_eval.mel_mag(wave)
        assert ours.shape == theirs.shape == (1 + len(wave) // 1024, 128)
        np.testing.assert_allclose(db(ours), db(theirs), atol=DB_ATOL, rtol=0)

    separator = SourceSeparator(params=separator_params, device="cpu")
    ours = eval_separator_pseudopop.separated_mel_mag(separator, mix)
    padded, true_frames = jax_sep.pad_bucket_wave(mix)
    power = np.asarray(jax_sep._separate_mel(separator_params, jsep.SeparatorConfig(),
                                             jnp.asarray(padded), true_frames), np.float32)
    theirs = np.sqrt(np.maximum(power[:, :true_frames], 0.0))
    assert ours.shape == theirs.shape == (5, true_frames, 128)
    for s in range(5):
        np.testing.assert_allclose(db(ours[s]), db(theirs[s]), atol=DB_ATOL, rtol=0)
    assert eval_separator_pseudopop.si_sdr(ours[1], theirs[1]) > 40.0
