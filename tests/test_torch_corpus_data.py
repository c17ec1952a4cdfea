"""The numpy paths of the aux models' corpus training in the port
(etude_tpu_torch/data/{synthetic,corpus_render,pseudopop}.py and the beat
scripts' grid helpers) against the JAX package's, bit for bit, on the same
seeded inputs and a synthetic corpus (etude_tpu_torch/tools/
synthetic_corpus.py), plus mirrors of tests/test_pseudopop.py's stem
renderer tests. The JAX scripts are imported through `sys.path`, as
tests/test_pseudopop.py does.

`render_serving` resamples 44.1 → 16 kHz: both packages evaluate scipy's
filter in a native kernel built from the same source with the same flags
(the JAX package falls back to scipy when its kernel does not build; the
port raises). Bit equality is held on the JAX package's native path (its
library must load), and the JAX scipy fallback within the resampling
tolerance of tests/test_torch_separation.py (1e-5).
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

import etude_tpu.data.corpus_render as jax_cr
import etude_tpu.data.pseudopop as jax_pp
import etude_tpu.data.synthetic as jax_syn
import etude_tpu.native as jax_native
from etude_tpu_torch import train_aux
from etude_tpu_torch.data import corpus_render as cr
from etude_tpu_torch.data import pseudopop as pp
from etude_tpu_torch.data import synthetic as syn
from etude_tpu_torch.scripts import distill_dataset, gen_beat_scenes, gen_pseudopop_scenes
from etude_tpu_torch.scripts import validate_beat_corpus
from etude_tpu_torch.tools.synthetic_corpus import VERSIONS, write_corpus
from etude_tpu_torch.utils.midi import read_midi_notes

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import distill_dataset as jax_distill  # noqa: E402
import gen_beat_scenes as jax_scenes  # noqa: E402
import gen_pseudopop_scenes as jax_ppscenes  # noqa: E402
import validate_beat_corpus as jax_validate  # noqa: E402

SR = 44100
RESAMPLE_ATOL = 1e-5


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("songs")
    write_corpus(root, n_songs=6, seconds=(20.0, 30.0), seed=0)
    return root


@pytest.fixture(scope="module")
def script():
    """scripts/train_aux_synthetic.py as a module (it has no package)."""
    spec = importlib.util.spec_from_file_location(
        "train_aux_synthetic", REPO / "scripts" / "train_aux_synthetic.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def native_resample():
    """The JAX resampler on its native path (no silent scipy fallback)."""
    assert jax_native.load_resample_library() is not None


@pytest.fixture
def scipy_resample(monkeypatch):
    """The JAX resampler on its scipy fallback."""
    def unavailable(*args, **kwargs):
        raise RuntimeError("native resampler disabled for the comparison")

    monkeypatch.setattr(jax_native, "upfirdn_poly_native", unavailable)


def same(a, b):
    """Equal values, types and dtypes, through dicts, lists, tuples and arrays."""
    if isinstance(a, (np.ndarray, np.generic)) or isinstance(b, (np.ndarray, np.generic)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        return
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    else:
        assert a == b


def _notes(seed, n=12, dur=6.0):
    rng = np.random.default_rng(seed)
    onsets = np.sort(rng.uniform(0.0, dur - 1.0, n))
    return [{"onset": float(t), "offset": float(t + rng.uniform(0.1, 1.0)),
             "pitch": int(rng.integers(36, 90)), "velocity": int(rng.integers(40, 120))}
            for t in onsets]


def _onset_energy(wave: np.ndarray, t: float, win: float = 0.03) -> float:
    i0 = int((t - win) * SR)
    i1 = int((t + win) * SR)
    seg = wave[max(i0, 0):max(i1, 0)]
    return float(np.sqrt((seg ** 2).mean())) if len(seg) else 0.0


class TestStemRenderers:
    """tests/test_pseudopop.py::TestStemRenderers on the port."""

    def test_drums_energy_on_beats(self):
        beats = np.arange(0.5, 7.5, 0.5)
        downs = beats[::4]
        wave = syn.render_drums(beats, downs, 8.0, sr=SR, seed=0)
        on = np.mean([_onset_energy(wave, b + 0.015) for b in beats])
        off = np.mean([_onset_energy(wave, b + 0.26, win=0.02) for b in beats[:-1]])
        assert on > 2.0 * off, (on, off)

    @pytest.mark.parametrize("render", [syn.render_vocal, syn.render_bass, syn.render_pad])
    def test_tonal_stems_finite_and_voiced(self, render):
        notes = [{"onset": 0.2, "offset": 1.2, "pitch": 60, "velocity": 90},
                 {"onset": 1.4, "offset": 2.2, "pitch": 67, "velocity": 80}]
        wave = render(notes, 3.0, sr=SR)
        assert np.isfinite(wave).all()
        assert _onset_energy(wave, 0.7) > 10 * _onset_energy(wave, 2.7)

    def test_vocal_formant_envelope(self):
        notes = [{"onset": 0.0, "offset": 1.0, "pitch": 69, "velocity": 100}]
        wave = syn.render_vocal(notes, 1.0, sr=SR)
        spec = np.abs(np.fft.rfft(wave[: SR]))
        freqs = np.fft.rfftfreq(SR, 1 / SR)
        near_formant = spec[(freqs > 350) & (freqs < 700)].max()
        high = spec[(freqs > 3000) & (freqs < 6000)].max()
        assert near_formant > high


# ---------------------------------------------------------- bit for bit
@pytest.mark.parametrize("name", ["render_vocal", "render_bass", "render_pad"])
def test_tonal_renderers_are_bit_equal(name):
    notes = _notes(1)
    same(getattr(syn, name)(notes, 6.0, sr=SR), getattr(jax_syn, name)(notes, 6.0, sr=SR))


def test_drums_are_bit_equal():
    beats = np.cumsum(np.random.default_rng(2).uniform(0.4, 0.6, 14))
    same(syn.render_drums(beats, beats[::4], 8.0, sr=SR, seed=5),
         jax_syn.render_drums(beats, beats[::4], 8.0, sr=SR, seed=5))


@pytest.mark.parametrize("jitter", [0.0, 0.008])
def test_build_stems_and_its_lines_are_bit_equal(jitter):
    notes = _notes(3, n=40, dur=8.0)
    beats = np.arange(0.25, 8.0, 0.5)
    downs = beats[::4]
    for fn in ("melody_line", "pad_chords", "bass_line"):
        args = {"melody_line": (notes, 8.0), "pad_chords": (notes, downs, 8.0),
                "bass_line": (notes, beats, 8.0)}[fn]
        same(getattr(pp, fn)(*args), getattr(jax_pp, fn)(*args))
    gains = dict(pp.MIX_GAINS, guitar=0.0, vocals=1.1)
    port = pp.build_stems(notes, beats, downs, 8.0, SR, seed=4, gains=gains,
                          drum_jitter=jitter, rng=np.random.default_rng(6))
    ref = jax_pp.build_stems(notes, beats, downs, 8.0, SR, seed=4, gains=gains,
                             drum_jitter=jitter, rng=np.random.default_rng(6))
    same(port, ref)
    for T in (None, 64):
        same(pp.stft_mag(port[0], n_frames=T), jax_pp.stft_mag(port[0], n_frames=T))
    same(pp.separation_example_from_stems(port[0], port[1], T=48),
         jax_pp.separation_example_from_stems(port[0], port[1], T=48))
    assert pp.STEM_NAMES == jax_pp.STEM_NAMES and pp.MIX_GAINS == jax_pp.MIX_GAINS


def test_split_and_song_dirs(corpus, monkeypatch):
    dirs = cr.corpus_song_dirs(corpus)
    assert [d.name for d in dirs] == [f"CPOP0{i}" for i in range(1, 7)]
    train, held_out = cr.split_songs(dirs)
    assert [d.name for d in held_out] == ["CPOP01", "CPOP04"]
    assert [d.name for d in train] == ["CPOP02", "CPOP03", "CPOP05", "CPOP06"]
    same(cr.split_songs(dirs), jax_cr.split_songs(jax_cr.corpus_song_dirs(corpus)))
    # The module's root is read at the call.
    monkeypatch.setattr(cr, "CORPUS_ROOT", corpus)
    assert cr.corpus_song_dirs() == dirs
    monkeypatch.setattr(cr, "CORPUS_ROOT", corpus / "missing")
    assert cr.corpus_song_dirs() == []
    assert cr.VERSIONS == jax_cr.VERSIONS and cr.RENDER_SR == jax_cr.RENDER_SR


def test_corpus_note_pool_windows_are_bit_equal(corpus):
    train, _ = cr.split_songs(cr.corpus_song_dirs(corpus))
    ours, ref = cr.CorpusNotePool(train), jax_cr.CorpusNotePool(train)
    # 4 train songs x 5 versions (human, etude_d, etude_d_d, etude_e, music2midi).
    assert ours.entries == ref.entries and len(ours.entries) == 20
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    for dur in (8.492, 8.492, 40.0, 8.492):
        same(ours.sample_window(r1, dur), ref.sample_window(r2, dur))


def test_render_serving_matches_jax(corpus, native_resample):
    pool = cr.CorpusNotePool(cr.split_songs(cr.corpus_song_dirs(corpus))[0])
    notes = pool.sample_window(np.random.default_rng(1), 3.0)
    straddling = [dict(n, onset=n["onset"] - 0.4) for n in notes]
    for ns in (notes, straddling):
        same(cr.render_serving(ns, 3.0), jax_cr.render_serving(ns, 3.0))


def test_render_serving_near_the_native_resampler(corpus, scipy_resample):
    pool = cr.CorpusNotePool(cr.split_songs(cr.corpus_song_dirs(corpus))[0])
    notes = pool.sample_window(np.random.default_rng(2), 3.0)
    np.testing.assert_allclose(cr.render_serving(notes, 3.0),
                               jax_cr.render_serving(notes, 3.0), atol=RESAMPLE_ATOL, rtol=0)


def test_grid_helpers_are_bit_equal_on_every_file(corpus):
    for song in cr.corpus_song_dirs(corpus):
        for version in VERSIONS:
            notes = read_midi_notes(song / f"{version}.mid")
            tempo = distill_dataset.estimate_tempo_grid(notes)
            same(tempo, jax_distill.estimate_tempo_grid(notes))
            same(distill_dataset.grid_fit_score(notes, tempo),
                 jax_distill.grid_fit_score(notes, tempo))
            same(distill_dataset.grid_slot_times(tempo, 12.0),
                 jax_distill.grid_slot_times(tempo, 12.0))
            for seconds, gate in ((180.0, 0.02), (12.0, 0.02), (180.0, 1e-4)):
                mid = song / f"{version}.mid"
                same(validate_beat_corpus.snap_gated_song(mid, seconds, gate),
                     jax_validate.snap_gated_song(mid, seconds, gate))
            same(validate_beat_corpus.grid_beat_times(tempo, 15.0),
                 jax_validate.grid_beat_times(tempo, 15.0))
    assert distill_dataset.estimate_tempo_grid(notes[:10]) is None


def test_snap_gated_pool_and_labels_are_bit_equal(corpus, script):
    train, _ = cr.split_songs(cr.corpus_song_dirs(corpus))
    pool = gen_beat_scenes.snap_gated_pool(train, 0.02)
    same(pool, jax_scenes.snap_gated_pool(train, 0.02))
    # Every train song's three grid versions pass the gate (an empty pool
    # would leave the scenes and the pseudo-pop rows with nothing to draw).
    assert len(pool) == 12
    for _song, _version, _notes, tempo in pool[::3]:
        for t0 in (0.0, 3.3, 7.91):
            same(gen_beat_scenes.window_labels(tempo, t0, 11.9, syn.BEAT_FPS),
                 jax_scenes.window_labels(tempo, t0, 11.9, syn.BEAT_FPS))
        beats = validate_beat_corpus.grid_beat_times(tempo, 30.0)
        downs = np.asarray([t for r in tempo for t in r["downbeats"]], np.float32)
        for start in (0, 37, 600):
            same(train_aux.beat_act_from_times(beats, downs, start, 512, syn.BEAT_FPS),
                 script._beat_act_from_times(beats, downs, start, 512, syn.BEAT_FPS))


def test_pseudopop_windows_and_raw_scenes_are_bit_equal(corpus):
    train, _ = cr.split_songs(cr.corpus_song_dirs(corpus))
    pool = gen_beat_scenes.snap_gated_pool(train, 0.02)
    r1, r2 = np.random.default_rng(11), np.random.default_rng(11)
    for dur in (6.0, 11.9, 6.0):
        same(gen_pseudopop_scenes.sample_window(r1, pool, dur),
             jax_ppscenes.sample_window(r2, pool, dur))
    assert gen_pseudopop_scenes.DROP_P == jax_ppscenes.DROP_P
    made = 0
    for _ in range(3):
        port = gen_pseudopop_scenes.make_scene_raw(r1, pool)
        same(port, jax_ppscenes.make_scene_raw(r2, pool))
        made += port is not None
    assert made > 0
