"""The port's polyphase resampler (etude_tpu_torch/ops/resample.py over
native/resample_fir.cc) against the JAX package's `resample_audio` (its own
copy of the kernel, etude_tpu/native/resample_fir.cc) and against scipy's
`resample_poly`, the plain version, at the serving path's rates: 44.1 → 16
kHz (Extract) and 44.1 → 22.05 kHz (the volume map).

Tolerance: f32 rounding. The kernel sums the filter's taps in f32 in
another order than scipy's upfirdn, so against scipy each sample may differ
by a few f32 ulps of the signal's scale: |diff| ≤ 8 · 2^-24 · max|x| ·
(the filter's absolute gain), here about 1e-6. Against the JAX package's
kernel, built from the same source with the same flags, the bits are equal.
"""

import numpy as np
import pytest
from scipy.signal import resample_poly

import etude_tpu.native as jax_native
from etude_tpu.utils import audio as jax_audio
from etude_tpu_torch.ops import _build, resample
from etude_tpu_torch.utils import audio

RATES = [(44100, 16000), (44100, 22050)]
ULP = 2.0 ** -24


def _wave(n, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def _scipy_atol(wave, up, down):
    hp, _ = resample.polyphase_filter(up, down)
    return 8 * ULP * float(np.abs(wave).max()) * float(np.abs(hp).sum(axis=1).max())


@pytest.mark.parametrize("orig,target", RATES)
@pytest.mark.parametrize("n", [1, 7, 100, 44100 * 3 + 11])
def test_native_matches_scipy(orig, target, n):
    wave = _wave(n, seed=n)
    g = np.gcd(orig, target)
    up, down = target // g, orig // g
    got = audio.resample_audio(wave, orig, target)
    want = resample_poly(wave, up, down).astype(np.float32)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=_scipy_atol(wave, up, down), rtol=0)


@pytest.mark.parametrize("orig,target", RATES)
@pytest.mark.parametrize("n", [7, 44100 * 3 + 11])
def test_native_equals_the_jax_resampler(orig, target, n):
    assert jax_native.load_resample_library() is not None
    wave = _wave(n, seed=n + 1)
    got = audio.resample_audio(wave, orig, target)
    want = jax_audio.resample_audio(wave, orig, target)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("orig,target", RATES)
def test_stereo_resamples_each_channel(orig, target):
    wave = np.stack([_wave(5000, 1), _wave(5000, 2)], axis=1)
    got = audio.resample_audio(wave, orig, target)
    assert got.shape[1] == 2
    for c in range(2):
        np.testing.assert_array_equal(got[:, c], audio.resample_audio(wave[:, c], orig, target))


def test_the_filter_is_scipys():
    """The polyphase split of the filter, read back as one impulse
    response, is scipy's (its output for a unit impulse)."""
    up, down = 160, 441
    impulse = np.zeros(2000, np.float32)
    impulse[1000] = 1.0
    np.testing.assert_allclose(resample.resample_poly_native(impulse, up, down),
                               resample_poly(impulse, up, down), atol=1e-7, rtol=0)


def test_same_rate_is_the_input():
    wave = _wave(100, 0)
    assert audio.resample_audio(wave, 16000, 16000) is wave


def test_a_library_that_does_not_build_raises(monkeypatch):
    """No quiet fall-back to scipy."""
    def broken(name):
        raise RuntimeError(f"building {name} failed")

    resample._resample_library.cache_clear()
    monkeypatch.setattr(_build, "load", broken)
    try:
        with pytest.raises(RuntimeError, match="resample_fir"):
            audio.resample_audio(_wave(100, 0), 44100, 16000)
    finally:
        resample._resample_library.cache_clear()
