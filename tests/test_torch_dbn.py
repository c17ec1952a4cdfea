"""The port's DBN beat / downbeat trackers (etude_tpu_torch/ops/dbn.py, with
its own native decoder native/dbn_viterbi.cc built by g++) and its octave
pass (ops/beat_octave.py) against the JAX package, on the click cases of
tests/test_beat.py.

Beat and downbeat times must be identical (atol 1e-9, the JAX package's
own native-vs-scan precedent): the same Viterbi on the same f32 tables. The
JAX side runs its C++ decoder and its device scan; both must agree with the
port.
"""

import numpy as np
import pytest

from etude_tpu.ops import beat_octave as jax_octave
from etude_tpu.ops import dbn as jax_dbn
from etude_tpu_torch.ops import _build, beat_octave, dbn

FPS = 43.066


def _click_activations(T, period, offset=0, peak=0.95, base=0.02):
    """Smooth 3-frame activation peaks on a regular grid (tests/test_beat.py)."""
    act = np.full(T, base)
    for t in range(offset, T, period):
        act[t] = peak
        if t + 1 < T:
            act[t + 1] = max(act[t + 1], peak * 0.6)
        if t - 1 >= 0:
            act[t - 1] = max(act[t - 1], peak * 0.6)
    return act


def _bar_activations(T, period, beats_per_bar):
    beat = _click_activations(T, period)
    down = np.full(T, 0.01)
    for t in range(0, T, beats_per_bar * period):
        down[t] = 0.9
        beat[t] = 0.05
    return np.stack([np.maximum(beat - down, 0), down], axis=-1)


@pytest.fixture(params=["native", "jax"])
def jax_backend(request, monkeypatch):
    monkeypatch.setenv("ETUDE_DBN_BACKEND", request.param)
    return request.param


@pytest.mark.parametrize("T,period", [(800, 20), (600, 18)])
def test_beat_tracker_matches_jax(T, period, jax_backend):
    act = _click_activations(T, period)
    kw = dict(min_bpm=70, max_bpm=250, fps=FPS, threshold=0.2)
    ours = dbn.DBNBeatTracker(**kw)(act)
    np.testing.assert_allclose(ours, jax_dbn.DBNBeatTracker(**kw)(act), atol=1e-9, rtol=0)
    # tests/test_beat.py::test_dbn_beat_tracker_recovers_click_grid
    if T == 800:
        assert len(ours) >= 35
        np.testing.assert_allclose(np.diff(ours), period / FPS, atol=0.05)


@pytest.mark.parametrize("T,meter", [(1600, 4), (1500, 3), (1200, 4)])
def test_downbeat_tracker_matches_jax(T, meter, jax_backend):
    combined = _bar_activations(T, 20, meter)
    kw = dict(beats_per_bar=(3, 4), min_bpm=70, max_bpm=250, fps=FPS, threshold=0.2)
    ours = dbn.DBNDownBeatTracker(**kw)(combined)
    np.testing.assert_allclose(ours, jax_dbn.DBNDownBeatTracker(**kw)(combined),
                               atol=1e-9, rtol=0)
    # tests/test_beat.py: the meter wins and downbeats follow it.
    downbeats = ours[ours[:, 1] == 1][:, 0]
    assert set(ours[:, 1].astype(int)) <= set(range(1, meter + 1))
    np.testing.assert_allclose(np.diff(downbeats), meter * 20 / FPS, atol=0.1)


def test_empty_and_silent():
    tracker = dbn.DBNBeatTracker(fps=FPS, threshold=0.2)
    assert len(tracker(np.zeros(100))) == 0
    assert len(tracker(np.empty(0))) == 0
    down = dbn.DBNDownBeatTracker(fps=FPS, threshold=0.2)
    assert down(np.zeros((100, 2))).shape == (0, 2)


def test_state_space_matches_jax():
    intervals = dbn._interval_range(70, 250, FPS)
    np.testing.assert_array_equal(intervals, jax_dbn._interval_range(70, 250, FPS))
    for blocks in (1, 3, 4):
        ours = dbn._StateSpace(intervals.astype(np.int64), blocks)
        ref = jax_dbn._StateSpace(intervals.astype(np.int64), blocks)
        for name in ("first", "last", "positions", "block_id", "in_beat"):
            np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name))
        np.testing.assert_array_equal(ours.tempo_log_transitions(),
                                      ref.tempo_log_transitions())


def test_random_activations_match_jax(jax_backend):
    """Noisy activations (many near-ties in the path) decode identically."""
    rng = np.random.default_rng(0)
    act = np.clip(_click_activations(700, 23) + 0.2 * rng.random(700), 0, 1)
    kw = dict(min_bpm=70, max_bpm=250, fps=FPS, threshold=0.2)
    np.testing.assert_allclose(dbn.DBNBeatTracker(**kw)(act),
                               jax_dbn.DBNBeatTracker(**kw)(act), atol=1e-9, rtol=0)


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """No scan to fall back on: a decoder that does not build is an error."""
    script = tmp_path / "g++"
    script.write_text('#!/bin/sh\necho "error: broken toolchain"; exit 1\n')
    script.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_gxx", lambda: str(script))
    monkeypatch.setattr(_build, "_loaded", {})
    dbn._dbn_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="broken toolchain"):
            dbn.DBNBeatTracker(fps=FPS)(_click_activations(200, 20))
    finally:
        dbn._dbn_library.cache_clear()


@pytest.mark.parametrize("case", ["half", "double", "identity", "short"])
def test_octave_pass_matches_jax(case):
    fps = 43.066
    T = 1200
    rng = np.random.default_rng(1)
    act = 0.05 + 0.02 * rng.random(T)
    true_period = 20
    for t in range(0, T, true_period):
        act[t] = 0.9
    grid = np.arange(0, T, true_period) / fps
    beats = {"half": grid[::2], "double": np.sort(np.concatenate([grid, grid[:-1] + 0.5 * np.diff(grid)])),
             "identity": grid, "short": grid[:5]}[case]
    ours = beat_octave.disambiguate_octave(beats, act, fps, min_bpm=60, max_bpm=250)
    ref = jax_octave.disambiguate_octave(beats, act, fps, min_bpm=60, max_bpm=250)
    assert ours[1] == ref[1]
    np.testing.assert_array_equal(ours[0], ref[0])
