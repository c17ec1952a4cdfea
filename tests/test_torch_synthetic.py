"""The port's own copies of the numpy pieces of aux training against the JAX
package's, on the same seeds: the synthetic corpora
(etude_tpu_torch/data/synthetic.py), the host log-mel (ops/mel.py
`log_mel_spectrogram_host`), the hFT input spec of the training script,
onset F1 (evaluation/metrics/onset_f1.py) and the host prefetch
(parallel/prefetch.py `prefetch`).

Tolerances: the corpora, the metrics and the batch order are bit-equal (the
same numpy calls in the same order); the log-mel to 1e-6 (numpy's FFT and
matmul in two processes of one machine, and an own copy of the filterbank).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from etude_tpu.data import synthetic as jax_syn
from etude_tpu.evaluation.metrics.onset_f1 import onset_f1 as jax_onset_f1
from etude_tpu.ops.mel import log_mel_spectrogram_host as jax_host_mel
from etude_tpu_torch.data import synthetic as syn
from etude_tpu_torch.evaluation.metrics.onset_f1 import onset_f1
from etude_tpu_torch.ops.mel import log_mel_spectrogram_host
from etude_tpu_torch.parallel.prefetch import prefetch
from etude_tpu_torch.train_aux import amt_spec_from_wave

REPO = Path(__file__).resolve().parent.parent
MEL_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def script():
    """scripts/train_aux_synthetic.py as a module (it has no package)."""
    spec = importlib.util.spec_from_file_location(
        "train_aux_synthetic", REPO / "scripts" / "train_aux_synthetic.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def assert_same(a, b):
    """Equal values, types and dtypes, through dicts, lists and arrays."""
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, (np.ndarray, np.generic)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def both(fn_name, *args, seed, **kw):
    """(port, JAX) results of `fn_name` called with a fresh generator each."""
    return (getattr(syn, fn_name)(np.random.default_rng(seed), *args, **kw),
            getattr(jax_syn, fn_name)(np.random.default_rng(seed), *args, **kw))


def test_constants_match():
    for name in ("BEAT_FPS", "AMT_SR", "AMT_HOP", "SEP_N_FFT", "SEP_F"):
        assert getattr(syn, name) == getattr(jax_syn, name)


@pytest.mark.parametrize("seed,T", [(0, 64), (1, 100), (5, 512)])
def test_beat_example_is_bit_equal(seed, T):
    port, ref = both("synth_beat_example", seed=seed, T=T)
    assert_same(port, ref)
    assert port["x"].shape == (5, T, 128)


def test_beat_batch_is_bit_equal():
    port, ref = both("beat_batch", 3, seed=11, T=48)
    assert_same(port, ref)


def test_beat_f_measure_and_power_to_db_are_bit_equal():
    rng = np.random.default_rng(2)
    for _ in range(5):
        ref_t = np.sort(rng.uniform(0, 10, rng.integers(0, 20)))
        est_t = np.sort(rng.uniform(0, 10, rng.integers(0, 20)))
        assert syn.beat_f_measure(est_t, ref_t) == jax_syn.beat_f_measure(est_t, ref_t)
    S = rng.gamma(1.0, 1.0, (4, 30)).astype(np.float32)
    assert_same(syn._power_to_db_np(S), jax_syn._power_to_db_np(S))


@pytest.mark.parametrize("nps", [2.0, 10.0])
def test_piano_notes_render_and_targets_are_bit_equal(nps):
    dur = 64 / (syn.AMT_SR / syn.AMT_HOP) + 0.3
    notes, ref_notes = both("synth_piano_notes", dur, seed=int(nps), notes_per_sec=nps)
    assert_same(notes, ref_notes)
    assert_same(syn.render_piano(notes, dur), jax_syn.render_piano(notes, dur))
    assert_same(syn.amt_targets(notes, 64), jax_syn.amt_targets(notes, 64))


def test_add_seg_edges_match():
    """Onsets before the buffer, past it and straddling its end."""
    for i0 in (-5, 0, 7, 28, 40):
        a, b = np.zeros(32, np.float32), np.zeros(32, np.float32)
        seg = np.arange(1, 9, dtype=np.float32)
        syn._add_seg(a, i0, seg)
        jax_syn._add_seg(b, i0, seg)
        assert_same(a, b)


def test_separation_example_batch_and_sdr_are_bit_equal():
    port, ref = both("synth_separation_example", seed=3, T=40)
    assert_same(port, ref)
    port, ref = both("separation_batch", 2, seed=4, T=24)
    assert_same(port, ref)
    est = port["stem_mags"][0] * 0.9
    assert_same(syn.stem_sdr(est, port["stem_mags"][0]),
                jax_syn.stem_sdr(est, port["stem_mags"][0]))


def test_host_mel_matches_jax():
    dur = 3.0
    notes = syn.synth_piano_notes(np.random.default_rng(8), dur)
    wave = syn.render_piano(notes, dur)
    kw = dict(sr=syn.AMT_SR, n_fft=2048, hop=syn.AMT_HOP, win_length=2048, n_mels=256)
    got, want = log_mel_spectrogram_host(wave, **kw), jax_host_mel(wave, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, **MEL_TOL)


def test_amt_spec_matches_the_script(script):
    """The margin-padded hFT input of one training clip, short and long."""
    rng = np.random.default_rng(9)
    for dur in (0.5, 64 / 62.5 + 0.3):
        wave = syn.render_piano(syn.synth_piano_notes(rng, dur), dur)
        np.testing.assert_allclose(amt_spec_from_wave(wave, 32, 64),
                                   script._amt_spec_from_wave(wave, 32, 64), **MEL_TOL)


@pytest.mark.parametrize("match_pitch", [True, False])
def test_onset_f1_is_bit_equal(match_pitch):
    rng = np.random.default_rng(12)

    def notes(n):
        return [{"onset": float(rng.uniform(0, 5)), "offset": 6.0,
                 "pitch": int(rng.integers(60, 64)), "velocity": 80} for _ in range(n)]

    for n_ref, n_est in ((20, 25), (0, 3), (4, 0), (30, 30)):
        ref, est = notes(n_ref), notes(n_est)
        assert_same(onset_f1(ref, est, match_pitch=match_pitch),
                    jax_onset_f1(ref, est, match_pitch=match_pitch))


def test_prefetch_order_matches_the_script(script):
    """One worker: the steps in order, as the script's; three workers: every
    step once."""
    def gen(i):
        return {"step": i}

    assert list(prefetch(gen, 7, workers=1)) == list(script.prefetch(gen, 7, workers=1))
    assert sorted(b["step"] for b in prefetch(gen, 10, workers=3)) == list(range(10))


def test_prefetch_raises_what_gen_fn_raised():
    def gen(i):
        if i == 2:
            raise KeyError("broken batch")
        return i

    with pytest.raises(KeyError, match="broken batch"):
        list(prefetch(gen, 5))
