"""The port's peak picker (etude_tpu_torch/ops/peakpick.py) against the JAX
package's (etude_tpu/ops/peakpick.py) on identical activations: the same
numpy code, so the note lists must be equal, not close."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from etude_tpu.ops import peakpick as jax_pp
from etude_tpu_torch.ops import peakpick as pp

HOP = 256 / 16000


def _maps(T=40, n_note=4):
    return (np.zeros((T, n_note), np.float32), np.zeros((T, n_note), np.float32),
            np.zeros((T, n_note), np.float32), np.full((T, n_note), 64, np.int32))


def _plateaus():
    onset, offset, mpe, vel = _maps()
    onset[5:8, 0] = 0.9                      # a plateau: a peak over 3 frames
    onset[20, 0] = 0.7
    onset[19, 0], onset[21, 0] = 0.6, 0.65   # asymmetric neighbours
    offset[12, 0] = 1.0                      # offset peak at the threshold
    mpe[5:15, 0] = 0.8
    mpe[20:26, 0] = 0.8
    return onset, offset, mpe, vel


def _boundaries():
    onset, offset, mpe, vel = _maps()
    onset[0, 1] = 0.8                        # first frame
    onset[-1, 1] = 0.8                       # last frame: no next onset
    offset[-1, 1] = 1.0
    mpe[:, 1] = 0.9                          # never falls below threshold
    onset[10, 2], onset[11, 2] = 0.95, 0.6   # a peak left of a falling edge
    return onset, offset, mpe, vel


def _zero_velocity_and_overlap():
    onset, offset, mpe, vel = _maps()
    onset[3, 3] = 0.9
    vel[3, 3] = 0                            # dropped: ignore_zero
    onset[8, 3] = 0.9
    onset[12, 3] = 0.9                       # same pitch again: truncates
    offset[30, 3] = 1.0                      # clamped to the next onset
    mpe[8:35, 3] = 0.7
    onset[15, 2], onset[16, 2] = 0.8, 0.8    # plateau, another pitch
    vel[15, 2] = 100
    return onset, offset, mpe, vel


CASES = {"plateaus": _plateaus, "boundaries": _boundaries,
         "zero_velocity_and_overlap": _zero_velocity_and_overlap}


@pytest.mark.parametrize("mode_offset", ["shorter", "longer", "offset"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_notes_equal_jax(case, mode_offset):
    maps = CASES[case]()
    kw = dict(hop_sec=HOP, note_min=21, thred_onset=0.5, thred_offset=1.0,
              thred_mpe=0.5, mode_offset=mode_offset)
    want = jax_pp.activations_to_notes(*maps, **kw)
    assert want, "the case should give the JAX picker notes"
    assert pp.activations_to_notes(*maps, **kw) == want


def test_rules_the_cases_exercise():
    """The cases reach the rules they are named for (on the port alone)."""
    notes = pp.activations_to_notes(*_zero_velocity_and_overlap(), hop_sec=HOP,
                                    thred_offset=1.0)
    pitch3 = [n for n in notes if n["pitch"] == 24]
    assert [n["velocity"] for n in pitch3] == [64, 64]           # zero dropped
    assert pitch3[0]["offset"] == pytest.approx(pitch3[1]["onset"])  # truncated
    locs, times = pp.detect_peaks(_plateaus()[0][:, 0], 0.5, HOP)
    assert list(locs) == [5, 6, 7, 20]
    assert times[3] != 20 * HOP                                  # interpolated


@settings(max_examples=200, deadline=None)
@given(data=st.data())
def test_random_maps_equal_jax(data):
    """Activations drawn from a few levels, so plateaus and ties are
    common, at random thresholds and policies."""
    T = data.draw(st.integers(1, 30))
    n_note = data.draw(st.integers(1, 3))
    levels = np.array([0.0, 0.3, 0.5, 0.7, 1.0], np.float32)
    draw_map = st.lists(st.integers(0, len(levels) - 1), min_size=T * n_note,
                        max_size=T * n_note)
    onset, offset, mpe = (levels[np.array(data.draw(draw_map))].reshape(T, n_note)
                          for _ in range(3))
    vel = np.array(data.draw(st.lists(st.integers(0, 3), min_size=T * n_note,
                                      max_size=T * n_note)), np.int32).reshape(T, n_note)
    kw = dict(hop_sec=HOP,
              thred_onset=data.draw(st.sampled_from([0.3, 0.5, 0.7])),
              thred_offset=data.draw(st.sampled_from([0.5, 1.0])),
              thred_mpe=data.draw(st.sampled_from([0.3, 0.5])),
              mode_offset=data.draw(st.sampled_from(["shorter", "longer", "offset"])),
              mode_velocity=data.draw(st.sampled_from(["ignore_zero", "keep"])))
    assert (pp.activations_to_notes(onset, offset, mpe, vel, **kw)
            == jax_pp.activations_to_notes(onset, offset, mpe, vel, **kw))
    for col in onset.T:
        got, want = pp.detect_peaks(col, kw["thred_onset"], HOP), jax_pp.detect_peaks(
            col, kw["thred_onset"], HOP)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
