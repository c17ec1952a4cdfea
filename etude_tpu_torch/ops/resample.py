"""Polyphase resampling on the host through the port's native FIR (JAX
counterparts: etude_tpu/utils/audio.py `_polyphase_filter` :57-87 and
`resample_audio` :90-117, etude_tpu/native/__init__.py `upfirdn_poly_native`
:189-204).

The filter is scipy's `resample_poly` default (a Kaiser-windowed sinc,
beta 5, unity DC gain times `up`), with scipy's pre-pad and trim, so the
output is scipy's up to f32 rounding: `native/resample_fir.cc` evaluates the
polyphase dot products in f32, threaded over output samples. There is no
fall-back: a library that does not build raises. scipy's `resample_poly`
is the plain version the tests hold it against.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Tuple

import numpy as np

from . import _build


@functools.cache
def polyphase_filter(up: int, down: int) -> Tuple[np.ndarray, int]:
    """(hp_rev [up, K] f32, n_pre_remove): scipy's resample_poly filter
    (window ('kaiser', 5.0)) split into `up` phases, each reversed, and the
    number of leading outputs scipy trims."""
    max_rate = max(up, down)
    f_c = 1.0 / max_rate
    half_len = 10 * max_rate
    numtaps = 2 * half_len + 1
    m = np.arange(numtaps, dtype=np.float64) - half_len
    h = f_c * np.sinc(f_c * m) * np.kaiser(numtaps, 5.0)
    h /= h.sum()          # firwin(scale=True): unity DC gain
    h *= up               # resample_poly's gain compensation
    n_pre_pad = down - half_len % down
    h = np.concatenate([np.zeros(n_pre_pad), h])
    n_pre_remove = (half_len + n_pre_pad) // down
    K = -(-len(h) // up)
    flat = np.zeros(K * up, np.float64)
    flat[: len(h)] = h
    hp = flat.reshape(K, up).T.astype(np.float32)
    hp_rev = np.ascontiguousarray(hp[:, ::-1])
    hp_rev.setflags(write=False)
    return hp_rev, n_pre_remove


@functools.cache
def _resample_library() -> ctypes.CDLL:
    lib = _build.load("resample_fir")
    lib.upfirdn_poly_f32.restype = None
    lib.upfirdn_poly_f32.argtypes = [
        ctypes.c_void_p,                          # hp_rev [up, K] f32
        ctypes.c_int64, ctypes.c_int64,           # up, K
        ctypes.c_void_p,                          # x [Lx] f32
        ctypes.c_int64, ctypes.c_int64,           # Lx, down
        ctypes.c_int64, ctypes.c_int64,           # n_start, n_out
        ctypes.c_void_p,                          # y [n_out] f32
        ctypes.c_int64,                           # n_threads
    ]
    return lib


def upfirdn_poly_native(hp_rev: np.ndarray, x: np.ndarray, down: int, n_start: int,
                        n_out: int) -> np.ndarray:
    """Polyphase upfirdn outputs n in [n_start, n_start + n_out) of the 1-D
    f32 signal `x`, on one thread per core (at most 8)."""
    hp_rev = np.ascontiguousarray(hp_rev, np.float32)
    x = np.ascontiguousarray(x, np.float32)
    up, K = hp_rev.shape
    y = np.empty(n_out, np.float32)
    _resample_library().upfirdn_poly_f32(hp_rev.ctypes.data, up, K, x.ctypes.data,
                                         x.shape[0], down, n_start, n_out, y.ctypes.data,
                                         min(8, os.cpu_count() or 1))
    return y


def resample_poly_native(wave: np.ndarray, up: int, down: int) -> np.ndarray:
    """`scipy.signal.resample_poly(wave, up, down)` along axis 0, in f32."""
    wave = np.asarray(wave, np.float32)
    if wave.ndim == 2:
        return np.stack([resample_poly_native(c, up, down) for c in wave.T], axis=1)
    if wave.ndim != 1:
        raise ValueError(f"expected a 1-D or 2-D waveform, got shape {wave.shape}")
    hp_rev, n_pre_remove = polyphase_filter(up, down)
    n = wave.shape[0] * up
    return upfirdn_poly_native(hp_rev, wave, down, n_pre_remove, n // down + bool(n % down))
