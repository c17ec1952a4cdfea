"""Dynamic-Bayesian-network beat / downbeat tracking (JAX counterpart:
etude_tpu/ops/dbn.py, its native branch).

The classic beat-tracking state space: one state per (phase, tempo) pair,
where tempo is an integer beat interval in frames, phase advances by one
frame, and tempo changes only at beat boundaries with probability
exp(-λ·|interval_to/interval_from − 1|) (transition_lambda = 100, madmom's
exponential model). The first 1/observation_lambda of each beat is a "beat"
state emitting the network activation; the rest emit
(1 - activation)/(λ_obs - 1). The downbeat variant stacks beats_per_bar beat
blocks into a bar cycle (one HMM per meter; the best-scoring meter wins),
with the first block's beat states emitting the downbeat column.

The Viterbi decode is host C++ (native/dbn_viterbi.cc, the port's own copy
of the JAX package's decoder), built with g++ at first use and called
through ctypes. It is the only decoder: a failed build raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Sequence, Tuple

import numpy as np

from . import _build

TRANSITION_LAMBDA = 100.0
OBSERVATION_LAMBDA = 16.0
EPS = 1e-20


@dataclasses.dataclass
class _StateSpace:
    """A cyclic chain of `n_blocks` beat blocks (1 for plain beat tracking,
    beats_per_bar for bar tracking), each holding every integer tempo."""

    intervals: np.ndarray          # [n_tempi] frames per beat
    n_blocks: int

    def __post_init__(self):
        per_block = int(self.intervals.sum())
        self.n_states = per_block * self.n_blocks
        # State layout: block-major, then interval-major, then phase.
        starts = np.concatenate([[0], np.cumsum(self.intervals)[:-1]])
        self.block_size = per_block
        # first/last state index per (block, tempo).
        self.first = (
            starts[None, :] + per_block * np.arange(self.n_blocks)[:, None]
        ).astype(np.int64)
        self.last = self.first + self.intervals[None, :] - 1
        # Phase position in [0, 1) and block id per state.
        pos = np.concatenate([np.arange(iv) / iv for iv in self.intervals])
        self.positions = np.tile(pos, self.n_blocks)
        self.block_id = np.repeat(np.arange(self.n_blocks), per_block)
        # Beat flag: within the first 1/OBSERVATION_LAMBDA of a beat.
        self.in_beat = np.tile(pos, self.n_blocks) < (1.0 / OBSERVATION_LAMBDA)

    def tempo_log_transitions(self) -> np.ndarray:
        """[n_from, n_to] log prob of an interval change at a beat boundary:
        exp(-λ·|to/from − 1|) over intervals, row-normalized (madmom's form,
        Krebs/Böck ISMIR 2015)."""
        ratio = self.intervals[None, :] / self.intervals[:, None].astype(np.float64)
        prob = np.exp(-TRANSITION_LAMBDA * np.abs(ratio - 1.0))
        prob[prob <= np.spacing(1)] = 0.0
        prob /= prob.sum(axis=1, keepdims=True)
        return np.log(np.maximum(prob, EPS))


def _interval_range(min_bpm: float, max_bpm: float, fps: float) -> np.ndarray:
    min_interval = int(np.round(fps * 60.0 / max_bpm))
    max_interval = int(np.round(fps * 60.0 / min_bpm))
    return np.arange(max(min_interval, 2), max_interval + 1)


@functools.cache
def _dbn_library() -> ctypes.CDLL:
    lib = _build.load("dbn_viterbi")
    lib.dbn_viterbi.restype = ctypes.c_double
    lib.dbn_viterbi.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,          # cols [T, n_cols], n_cols
        ctypes.c_void_p,                          # ptr [S] int8
        ctypes.c_int64, ctypes.c_int64,           # T, S
        ctypes.c_void_p, ctypes.c_void_p,         # first_idx, last_idx int64
        ctypes.c_int64, ctypes.c_int64,           # n_blocks, n_tempi
        ctypes.c_void_p,                          # logT [n_tempi, n_tempi] f32
        ctypes.c_void_p,                          # out_path [T] int64
    ]
    return lib


def viterbi_native(cols: np.ndarray, ptr: np.ndarray, first_idx: np.ndarray,
                   last_idx: np.ndarray, logT: np.ndarray) -> Tuple[np.ndarray, float]:
    """Structured Viterbi over a [T, n_cols] observation log-density table
    and a per-state column pointer [S]: returns (state path [T], final log
    probability)."""
    cols = np.ascontiguousarray(cols, np.float32)
    ptr = np.ascontiguousarray(ptr, np.int8)
    first = np.ascontiguousarray(first_idx, np.int64)
    last = np.ascontiguousarray(last_idx, np.int64)
    logT = np.ascontiguousarray(logT, np.float32)
    T, n_cols = cols.shape
    n_blocks, n_tempi = first.shape
    path = np.empty(T, np.int64)
    log_prob = _dbn_library().dbn_viterbi(
        cols.ctypes.data, n_cols, ptr.ctypes.data, T, ptr.shape[0],
        first.ctypes.data, last.ctypes.data, n_blocks, n_tempi,
        logT.ctypes.data, path.ctypes.data,
    )
    return path, float(log_prob)


class _DBNTracker:
    """Shared machinery for beat and bar tracking."""

    def __init__(self, intervals: np.ndarray, n_blocks: int):
        self.ss = _StateSpace(intervals.astype(np.int64), n_blocks)
        self.logT = self.ss.tempo_log_transitions().astype(np.float32)

    def _decode(self, cols_log: np.ndarray, ptr: np.ndarray) -> Tuple[np.ndarray, float]:
        return viterbi_native(cols_log, ptr, self.ss.first, self.ss.last, self.logT)


def _threshold_trim(act: np.ndarray, threshold: float) -> Tuple[np.ndarray, int]:
    """Trim leading/trailing frames below threshold (madmom-style)."""
    if threshold <= 0:
        return act, 0
    level = act if act.ndim == 1 else act.sum(axis=-1)
    above = np.nonzero(level >= threshold)[0]
    if len(above) == 0:
        return act[:0], 0
    return act[above[0]: above[-1] + 1], int(above[0])


def _peak_segments(in_range: np.ndarray) -> List[Tuple[int, int]]:
    """Contiguous [left, right) segments where in_range is True."""
    idx = np.nonzero(np.diff(in_range.astype(np.int8)))[0] + 1
    bounds = list(idx)
    if in_range.size and in_range[0]:
        bounds = [0] + bounds
    if in_range.size and in_range[-1]:
        bounds = bounds + [in_range.size]
    return list(zip(bounds[0::2], bounds[1::2]))


class DBNBeatTracker:
    """activations [T] → beat times (seconds)."""

    def __init__(self, min_bpm: float = 55.0, max_bpm: float = 215.0,
                 fps: float = 100.0, threshold: float = 0.0):
        self.fps = fps
        self.threshold = threshold
        self.tracker = _DBNTracker(_interval_range(min_bpm, max_bpm, fps), 1)

    def __call__(self, activations: np.ndarray) -> np.ndarray:
        act, first = _threshold_trim(np.asarray(activations, np.float64),
                                     self.threshold)
        if act.size == 0 or not act.any():  # madmom: silence → no beats
            return np.empty(0)
        ss = self.tracker.ss
        beat_log = np.log(np.maximum(act, EPS))
        nobeat_log = np.log(np.maximum((1.0 - act) / (OBSERVATION_LAMBDA - 1), EPS))
        cols = np.stack([nobeat_log, beat_log], axis=1).astype(np.float32)
        path, _ = self.tracker._decode(cols, ss.in_beat.astype(np.int8))

        # Correct beats to the activation peak within each beat-range segment.
        beats = [int(np.argmax(act[l:r])) + l
                 for l, r in _peak_segments(ss.in_beat[path])]
        return (np.asarray(beats, np.float64) + first) / self.fps


class DBNDownBeatTracker:
    """activations [T, 2] (beat, downbeat) → array of (time, beat_number)."""

    def __init__(self, beats_per_bar: Sequence[int] = (3, 4),
                 min_bpm: float = 55.0, max_bpm: float = 215.0,
                 fps: float = 100.0, threshold: float = 0.0):
        self.fps = fps
        self.threshold = threshold
        intervals = _interval_range(min_bpm, max_bpm, fps)
        self.patterns = [(bpb, _DBNTracker(intervals, bpb)) for bpb in beats_per_bar]

    def __call__(self, activations: np.ndarray) -> np.ndarray:
        act, first = _threshold_trim(np.asarray(activations, np.float64),
                                     self.threshold)
        if act.shape[0] == 0 or not act.any():  # madmom: silence → no beats
            return np.empty((0, 2))

        no_beat = np.log(np.maximum(
            (1.0 - act.sum(axis=1)) / (OBSERVATION_LAMBDA - 1), EPS))
        beat = np.log(np.maximum(act[:, 0], EPS))
        down = np.log(np.maximum(act[:, 1], EPS))
        cols = np.stack([no_beat, beat, down], axis=1).astype(np.float32)
        best = None
        for bpb, tracker in self.patterns:
            ss = tracker.ss
            # Pointer per state: 0 none, 1 beat, 2 downbeat.
            ptr = np.zeros(ss.n_states, np.int8)
            ptr[ss.in_beat] = 1
            ptr[ss.in_beat & (ss.block_id == 0)] = 2
            path, log_prob = tracker._decode(cols, ptr)
            if best is None or log_prob > best[0]:
                best = (log_prob, tracker, path, ptr)

        _, tracker, path, ptr = best
        out = []
        for l, r in _peak_segments(ptr[path] >= 1):
            # madmom's correction: argmax over the FLATTENED [seg, 2] slice
            # (the strongest activation in either column picks the frame).
            peak = int(np.argmax(act[l:r])) // act.shape[1] + l
            beat_number = int(tracker.ss.block_id[path[peak]]) + 1
            out.append(((peak + first) / self.fps, beat_number))
        return np.asarray(out) if out else np.empty((0, 2))
