"""The port's aligner (etude_tpu_torch/ops/chroma.py, ops/dtw.py,
native/dtw_band.cc, data/aligner.py) against the JAX package's
(etude_tpu/ops/chroma.py, ops/dtw.py, native/dtw_band.cc,
data/aligner.py), on the CPU, on the same numpy inputs.

Tolerances:
- Chroma and onset features, with the same power spectrum handed to both
  (the f64 FFT rounded to f32): the chroma to 1e-5 absolute (measured up
  to 1.2e-7), the onsets to 1e-4 (measured up to 2.1e-5, in 1 of 5,112
  entries; 6.5e-6 in 8 renders at 0 cents). The onsets are
  ill-conditioned: each frame divides a difference of log chroma by its
  largest entry and is normalized to unit length, so the last bits of the
  filterbank's f32 matmul, where XLA's and MKL's GEMMs round differently,
  are amplified. With each package's own f32 matmul DFT they differ by up
  to 5.5e-3 (the chroma by 5.5e-6), so those features are held on the
  chroma only, to 2e-5, and through the paths they give, which must be
  equal.
- The tuning estimate, the key shift, the wavefront's codes and final
  costs, the banded DP's codes and the paths: equal, bit for bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import etude_tpu.data.aligner as jax_aligner
from etude_tpu.native import dtw_band_native as jax_dtw_band_native
from etude_tpu.ops import chroma as jax_chroma
from etude_tpu.ops import dtw as jax_dtw
from etude_tpu.ops import mel as jax_mel
import etude_tpu_torch.data.aligner as aligner
from etude_tpu_torch.data.synthetic import render_piano, synth_piano_notes
from etude_tpu_torch.ops import chroma, dtw
from etude_tpu_torch.utils.audio import save_wav

SR = 22050
CHROMA_ATOL, ONSET_ATOL = 1e-5, 1e-4
CHROMA_OWN_DFT_ATOL = 2e-5


def piano_pair(seed, seconds=10.0, stretch=1.2, transpose=3, sr=SR):
    """(origin, cover): a piano render from a seed, and the same notes
    transposed and time-warped by t → stretch·t + 0.3·sin(t/3)."""
    notes = synth_piano_notes(np.random.default_rng(seed), seconds)

    def warp(t):
        return stretch * t + 0.3 * np.sin(t / 3.0)

    cover_notes = [{"onset": warp(n["onset"]), "offset": warp(n["offset"]),
                    "pitch": min(n["pitch"] + transpose, 108), "velocity": n["velocity"]}
                   for n in notes]
    return (render_piano(notes, seconds + 0.5, sr=sr),
            render_piano(cover_notes, warp(seconds) + 0.5, sr=sr))


def _f64_power(frames):
    spec = np.fft.rfft(np.asarray(frames, np.float64), axis=-1)
    return (spec.real ** 2 + spec.imag ** 2).astype(np.float32)


@pytest.fixture
def shared_spectrum(monkeypatch):
    """Both packages' chroma take their power spectrum from the same f64
    FFT; the JAX jit cache is cleared before and after."""
    def jax_power(frames, cos_m, sin_m):
        return jax.pure_callback(
            _f64_power, jax.ShapeDtypeStruct((frames.shape[0], cos_m.shape[1]), jnp.float32),
            frames)

    monkeypatch.setattr(jax_mel, "frame_power_spectrum", jax_power)
    monkeypatch.setattr(chroma, "frame_power_spectrum",
                        lambda frames, cos_m, sin_m: torch.from_numpy(_f64_power(frames.numpy())))
    jax_chroma._chroma_core.clear_cache()
    yield
    jax_chroma._chroma_core.clear_cache()


@pytest.mark.parametrize("seed,cents", [(0, 0.0), (1, -20.0), (2, 30.0)])
def test_features_equal_jax_on_the_same_spectrum(seed, cents, shared_spectrum):
    wave, _ = piano_pair(seed, seconds=8.0)
    got = chroma.chroma_features(wave, tuning_cents=cents, device="cpu")
    want = jax_chroma.chroma_features(wave, tuning_cents=cents)
    for g, w, name, atol in zip(got, want, ("chroma", "onset"), (CHROMA_ATOL, ONSET_ATOL)):
        assert g.shape == w.shape == (len(wave) // 441 + 1, 12), name
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("seed", [3, 4])
def test_chroma_of_each_dft_equal_jax(seed):
    wave, _ = piano_pair(seed, seconds=8.0)
    got, _ = chroma.chroma_features(wave, device="cpu")
    want, _ = jax_chroma.chroma_features(wave)
    np.testing.assert_allclose(got, want, atol=CHROMA_OWN_DFT_ATOL, rtol=0)


def test_features_do_not_depend_on_the_bucket():
    """The JAX package pads to 2048-frame buckets; the port computes the
    true frames alone. A wave cut short gives the same leading frames."""
    wave, _ = piano_pair(5, seconds=6.0)
    full_c, full_o = chroma.chroma_features(wave, device="cpu")
    cut = len(wave) // 2
    part_c, part_o = chroma.chroma_features(wave[:cut], device="cpu")
    n = cut // 441 - 10   # frames whose windows end before the cut
    np.testing.assert_array_equal(part_c[:n], full_c[:n])
    np.testing.assert_array_equal(part_o[:n], full_o[:n])


@pytest.mark.parametrize("transpose", [0, 2, -5, 7])
def test_tuning_and_key_shift_equal_jax(transpose):
    origin, cover = piano_pair(6, seconds=8.0, transpose=transpose)
    assert chroma.estimate_tuning(cover) == jax_chroma.estimate_tuning(cover)
    a, _ = jax_chroma.chroma_features(cover)
    b, _ = jax_chroma.chroma_features(origin)
    shift = chroma.optimal_chroma_shift(a, b)
    assert shift == jax_chroma.optimal_chroma_shift(a, b)
    assert shift == transpose % 12


def _costs(kind, N, M, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.uniform(0, 2, size=(N, M)).astype(np.float32)
    if kind == "wide":
        return rng.uniform(0, 1000, size=(N, M)).astype(np.float32)
    if kind == "constant":
        return np.ones((N, M), np.float32)
    if kind == "integers":
        return rng.integers(0, 3, size=(N, M)).astype(np.float32)
    return (rng.integers(0, 8, size=(N, M)) / 4).astype(np.float32)   # quarters


@pytest.mark.parametrize("kind,N,M", [
    ("uniform", 50, 70), ("uniform", 130, 90), ("wide", 64, 64), ("constant", 60, 60),
    ("integers", 80, 100), ("quarters", 200, 150), ("uniform", 1, 7), ("uniform", 7, 1),
])
def test_wavefront_codes_equal_jax(kind, N, M):
    cost = _costs(kind, N, M, seed=N * M)
    want_final, want_codes = jax_dtw._dtw_scan(cost)
    final, codes = dtw._dtw_scan(torch.from_numpy(cost))
    assert codes.dtype == torch.uint8 and codes.shape == (N + M - 1, N)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    np.testing.assert_array_equal(final.numpy(), np.asarray(want_final))


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_dtw_path_equals_jax(kind):
    """Random unit features, and features whose products are exact in f32
    (entries of ±1/2 and 0 over four dimensions), which give costs with many
    exact ties."""
    rng = np.random.default_rng(11)
    if kind == "random":
        a_c, a_o = _unit(rng.uniform(size=(90, 12))), _unit(rng.uniform(size=(90, 12)))
        b_c, b_o = _unit(rng.uniform(size=(120, 12))), _unit(rng.uniform(size=(120, 12)))
    else:
        def pick(n):
            return (rng.integers(-1, 2, size=(n, 12)) * 0.5).astype(np.float32)
        a_c, a_o, b_c, b_o = pick(90), pick(90), pick(120), pick(120)
    want = jax_dtw.dtw_path(a_c, a_o, b_c, b_o)
    got = dtw.dtw_path(a_c, a_o, b_c, b_o, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert np.all(np.diff(got, axis=1) >= 1)


def _smooth_features(T, d=12, seed=3, step=6):
    """Slowly varying ℓ2-normalized features (tests/test_align.py's)."""
    rng = np.random.default_rng(seed)
    anchors = rng.uniform(0.1, 1.0, size=(T // step + 2, d))
    x = np.stack([
        np.interp(np.arange(T), np.arange(len(anchors)) * step, anchors[:, j])
        for j in range(d)
    ], axis=1).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _warped_pair(n_a, n_b, seed=3):
    a = _smooth_features(n_a, seed=seed)
    t = np.arange(n_a)
    warp = np.cumsum(1.0 + 0.6 * np.sin(np.pi * t / n_a) ** 2)
    warp = (warp / warp[-1] * (n_b - 1)).astype(int)
    b = a[np.searchsorted(warp, np.arange(n_b), "left").clip(0, n_a - 1)]
    return a, _smooth_features(n_a, seed=seed + 1), b, _smooth_features(n_b, seed=seed + 2)


def test_native_band_dp_equals_its_plain_version_and_jax():
    a, oa, b, ob = _warped_pair(120, 80, seed=7)
    centers = np.linspace(0, 79, 120).round().astype(np.int64)
    centers[0] = min(centers[0], 12)
    centers[-1] = max(centers[-1], 79 - 12)
    cost = dtw._banded_cost(a, oa, b, ob, centers, 12, 0.5)
    np.testing.assert_array_equal(cost, jax_dtw._banded_cost(a, oa, b, ob, centers, 12, 0.5))

    codes, final = dtw.dtw_band_native(cost, 80, centers)
    plain_codes, plain_final = dtw._dtw_band_numpy(cost, 80, centers)
    np.testing.assert_array_equal(codes, plain_codes)
    # The plain version rounds each weighted cost to f32 first.
    assert final == pytest.approx(plain_final, rel=1e-6)
    jax_codes, jax_final = jax_dtw_band_native(cost, 80, centers)
    np.testing.assert_array_equal(codes, jax_codes)
    assert final == jax_final


@pytest.mark.parametrize("n_a,n_b,levels,band", [
    (300, 450, (4, 1), 40), (900, 700, (16, 4, 1), 64)])
def test_mrms_path_equals_jax(n_a, n_b, levels, band):
    a, oa, b, ob = _warped_pair(n_a, n_b)
    want = jax_dtw.mrms_dtw_path(a, oa, b, ob, levels=levels, band=band)
    got = dtw.mrms_dtw_path(a, oa, b, ob, levels=levels, band=band, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert tuple(got[:, 0]) == (0, 0) and tuple(got[:, -1]) == (n_a - 1, n_b - 1)


def _assert_result_equal(got, want):
    np.testing.assert_array_equal(got["wp"], want["wp"])
    assert {k: v for k, v in got.items() if k != "wp"} == \
        {k: v for k, v in want.items() if k != "wp"}


@pytest.mark.parametrize("seed,transpose", [(0, 3), (1, -2)])
def test_warping_path_equals_jax(seed, transpose):
    origin, cover = piano_pair(seed, seconds=12.0, transpose=transpose)
    want = jax_aligner.AudioAligner().compute_warping_path(origin, cover)
    got = aligner.AudioAligner(device="cpu").compute_warping_path(origin, cover)
    _assert_result_equal(got, want)
    assert got["pitch_shift"] == -transpose
    # The path follows the warp: origin time ≈ cover time / stretch.
    mid = (got["wp"][0] > 50) & (got["wp"][0] < got["wp"][0][-1] - 50)
    slope = np.polyfit(got["wp"][0][mid], got["wp"][1][mid], 1)[0]
    assert abs(slope - 1 / 1.2) < 0.05


def test_banded_route_equals_jax(monkeypatch):
    """Above _FULL_DTW_MAX_CELLS both packages take the multi-resolution
    path."""
    origin, cover = piano_pair(2, seconds=12.0)
    monkeypatch.setattr(jax_aligner, "_FULL_DTW_MAX_CELLS", 1000)
    monkeypatch.setattr(aligner, "_FULL_DTW_MAX_CELLS", 1000)
    calls = []
    real = aligner.mrms_dtw_path
    monkeypatch.setattr(aligner, "mrms_dtw_path",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    want = jax_aligner.AudioAligner().compute_warping_path(origin, cover)
    got = aligner.AudioAligner(device="cpu").compute_warping_path(origin, cover)
    assert calls == [1]
    _assert_result_equal(got, want)


def test_each_package_reads_the_others_wp_json(tmp_path):
    origin, cover = piano_pair(3, seconds=6.0)
    for side in ("jax", "port"):
        save_wav(tmp_path / side / "origin.wav", origin, SR)
        save_wav(tmp_path / side / "cover.wav", cover, SR)
    jax_result = jax_aligner.AudioAligner().align(
        tmp_path / "jax" / "origin.wav", tmp_path / "jax" / "cover.wav", tmp_path / "jax")
    port_result = aligner.AudioAligner(device="cpu").align(
        tmp_path / "port" / "origin.wav", tmp_path / "port" / "cover.wav", tmp_path / "port")
    _assert_result_equal(port_result, jax_result)
    assert (json.loads((tmp_path / "port" / "wp.json").read_text())
            == json.loads((tmp_path / "jax" / "wp.json").read_text()))

    # Swap the caches, remove the audio: each reads the other's file.
    (tmp_path / "jax" / "wp.json").rename(tmp_path / "tmp.json")
    (tmp_path / "port" / "wp.json").rename(tmp_path / "jax" / "wp.json")
    (tmp_path / "tmp.json").rename(tmp_path / "port" / "wp.json")
    for side in ("jax", "port"):
        (tmp_path / side / "origin.wav").unlink()
    from_jax = aligner.AudioAligner(device="cpu").align(
        tmp_path / "port" / "origin.wav", tmp_path / "port" / "cover.wav", tmp_path / "port")
    from_port = jax_aligner.AudioAligner().align(
        tmp_path / "jax" / "origin.wav", tmp_path / "jax" / "cover.wav", tmp_path / "jax")
    _assert_result_equal(from_jax, jax_result)
    _assert_result_equal(from_port, jax_result)


def test_aligner_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        aligner.AudioAligner()
