"""Reduction of a `torch.profiler` run to what the metrics read.

Device operations are the CUDA activity of the trace (kernels, copies and
sets), each with the correlation id of the runtime call that launched it. Host events are the runtime calls (always recorded, from
every thread) and, with host tracing on, the operations and the harness's
`record_function` spans ("bench.*") of the thread that started the
profiler. Spans that a driver records itself around work on other threads
(name, thread ids, start and end in `time.time_ns()`, the trace's clock)
split device time between stages and name idle gaps there.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ANNOTATION_PREFIX = "bench."
RUNTIME_PREFIX = "cu"        # cudaLaunchKernel, cuLaunchKernelEx, cudaMemcpyAsync, ...
TOP = 10


def thread_ids(native_id: int, ident: int) -> frozenset:
    """The ids a profiler may give one thread: its system id, or (for the
    runtime calls of threads it did not start on) its pthread id, whole or
    cut to 32 bits either way."""
    low = ident & 0xFFFFFFFF
    return frozenset({native_id, ident, low, low - (1 << 32) if low >= 1 << 31 else low})


@dataclasses.dataclass
class Trace:
    # device operations, sorted by start: name, start and end (s), the
    # correlation id of the launching runtime call
    dev_name: List[str]
    dev_start: np.ndarray
    dev_end: np.ndarray
    dev_corr: np.ndarray
    # host events: name, start, end (s), thread, correlation id
    host_name: List[str]
    host_start: np.ndarray
    host_end: np.ndarray
    host_thread: np.ndarray
    host_corr: np.ndarray
    host_runtime: np.ndarray       # a runtime call (what launches device work)
    host_annotation: np.ndarray    # a harness span
    spans: List[Tuple[str, frozenset, float, float]]
    t_begin: float
    t_end: float
    _launchers: Optional[np.ndarray] = None

    @classmethod
    def of(cls, prof, spans: Sequence[tuple] = ()) -> "Trace":
        """Read a stopped profiler's events (its kineto results, without
        building the profiler's own event tree); `spans` as (name, thread
        ids, start ns, end ns)."""
        from torch.autograd import DeviceType

        dev, host = [], []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                if e.is_user_annotation() or e.name().startswith(ANNOTATION_PREFIX):
                    continue    # a host span drawn on the device's timeline
                dev.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                            e.correlation_id()))
            elif e.device_type() == DeviceType.CPU and not e.is_async():
                host.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                             e.device_resource_id(), e.correlation_id(),
                             bool(e.is_user_annotation())))
        dev.sort(key=lambda r: r[1])
        host.sort(key=lambda r: r[1])

        def col(rows, i, dtype=np.float64, scale=1.0):
            return (np.array([r[i] for r in rows], dtype=dtype) * scale if rows
                    else np.zeros(0, dtype))

        names = [r[0] for r in host]
        trace = cls(
            dev_name=[r[0] for r in dev], dev_start=col(dev, 1, scale=1e-9),
            dev_end=col(dev, 2, scale=1e-9), dev_corr=col(dev, 3, np.int64),
            host_name=names, host_start=col(host, 1, scale=1e-9),
            host_end=col(host, 2, scale=1e-9), host_thread=col(host, 3, np.int64),
            host_corr=col(host, 4, np.int64),
            host_runtime=np.array([n.startswith(RUNTIME_PREFIX) for n in names], dtype=bool),
            host_annotation=col(host, 5, bool),
            spans=[(name, ids, start * 1e-9, end * 1e-9) for name, ids, start, end in spans],
            t_begin=0.0, t_end=0.0)
        starts = [a[0] for a in (trace.dev_start, trace.host_start) if len(a)]
        ends = [a.max() for a in (trace.dev_end, trace.host_end) if len(a)]
        trace.t_begin, trace.t_end = min(starts, default=0.0), max(ends, default=0.0)
        return trace

    # ---- the device's time ----------------------------------------------
    def busy_intervals(self, mask: Optional[np.ndarray] = None) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals (over all streams),
        of those in `mask` where given."""
        start, end = self.dev_start, self.dev_end
        if mask is not None:
            start, end = start[mask], end[mask]
        merged: List[Tuple[float, float]] = []
        for s, e in zip(start.tolist(), end.tolist()):   # sorted by start
            if merged and s <= merged[-1][1]:
                if e > merged[-1][1]:
                    merged[-1] = (merged[-1][0], e)
            else:
                merged.append((s, e))
        return merged

    def busy_s(self, mask: Optional[np.ndarray] = None) -> float:
        return float(sum(e - s for s, e in self.busy_intervals(mask)))

    def kernel_mask(self, substring: str) -> np.ndarray:
        return np.array([substring in n for n in self.dev_name], dtype=bool)

    def device_s(self, mask: np.ndarray) -> float:
        """The summed duration of the device operations in `mask`."""
        return float((self.dev_end[mask] - self.dev_start[mask]).sum())

    # ---- what launched what ---------------------------------------------
    def launchers(self) -> np.ndarray:
        """For each device operation, the index of the runtime call that
        launched it (-1 where the trace does not hold it)."""
        if self._launchers is None:
            rt = np.nonzero(self.host_runtime)[0]
            by_corr = dict(zip(self.host_corr[rt].tolist(), rt.tolist()))
            self._launchers = np.array([by_corr.get(c, -1) for c in self.dev_corr.tolist()],
                                       dtype=np.int64)
        return self._launchers

    def _span_windows(self, name: str):
        """(thread ids, start, end) of every span called `name`: the
        driver's own and the profiler's annotations."""
        out = [(ids, s, e) for n, ids, s, e in self.spans if n == name]
        for i in np.nonzero(self.host_annotation)[0].tolist():
            if self.host_name[i] == name:
                out.append((frozenset({int(self.host_thread[i])}), self.host_start[i],
                            self.host_end[i]))
        return out

    def launched_in(self, name: str) -> np.ndarray:
        """Mask of the device operations launched inside span `name` (by a
        runtime call on the span's thread, within it)."""
        launched = np.zeros(len(self.dev_name), dtype=bool)
        windows = self._span_windows(name)
        if not windows or not self.host_name:
            return launched
        calls = self.launchers()
        has = calls >= 0
        thread = np.where(has, self.host_thread[np.maximum(calls, 0)], -1)
        when = np.where(has, self.host_start[np.maximum(calls, 0)], -np.inf)
        for ids, start, end in windows:
            launched |= has & np.isin(thread, list(ids)) & (when >= start) & (when <= end)
        return launched

    def _host_context(self, call: int) -> str:
        """What the host was doing at runtime call `call`: the innermost span
        around it on its thread, then the innermost operation (the call's
        own name where none was traced)."""
        if call < 0:
            return "host"
        t, thread = self.host_start[call], int(self.host_thread[call])
        around = np.nonzero((self.host_thread == thread) & (self.host_start <= t)
                            & (self.host_end >= t))[0].tolist()

        def innermost(cands):
            return min(cands, key=lambda j: self.host_end[j] - self.host_start[j], default=None)

        op = innermost([j for j in around if not self.host_annotation[j]
                        and not self.host_runtime[j]])
        spans = [(e - s, n) for n, ids, s, e in self.spans if thread in ids and s <= t <= e]
        span = innermost([j for j in around if self.host_annotation[j]])
        parts = [min(spans)[1]] if spans else ([self.host_name[span]] if span is not None else [])
        parts.append(self.host_name[op] if op is not None else self.host_name[call])
        return "/".join(parts)

    # ---- the breakdown ----------------------------------------------------
    def top_device_ops(self, n: int = TOP) -> List[List]:
        totals: Dict[str, float] = collections.defaultdict(float)
        for name, dur in zip(self.dev_name, (self.dev_end - self.dev_start).tolist()):
            totals[name] += dur
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], seconds] for name, seconds in top]

    def idle_gaps(self, n: int = TOP) -> List[List]:
        """The longest stretches in which no device operation ran, each named
        by what the host was doing when it launched the operation that ends
        the gap."""
        merged = self.busy_intervals()
        if not merged:
            return []
        bounds = [(self.t_begin, merged[0][0], 0)]
        bounds += [(merged[k][1], merged[k + 1][0], k + 1) for k in range(len(merged) - 1)]
        gaps = sorted(((e - s, k) for s, e, k in bounds if e > s), reverse=True)[:n]
        calls = self.launchers()
        out = []
        for length, k in gaps:
            j = min(int(np.searchsorted(self.dev_start, merged[k][0])), len(self.dev_start) - 1)
            out.append([self._host_context(int(calls[j]))[:120], length])
        return out

    def breakdown(self) -> Dict[str, List]:
        return {"device_ops": self.top_device_ops(), "idle_gaps": self.idle_gaps()}
