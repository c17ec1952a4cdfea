"""Named wall-clock spans and the profiler trace (JAX counterpart:
etude_tpu/utils/profiling.py `StageTimer`, `maybe_span`, `trace`).

A span on a CUDA device ends by synchronizing the calling thread's current
stream, so it holds the device work queued inside it. The pipeline runs
its concurrent stages on threads with a stream each, so one stage's span
does not wait on the other's work.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from .logger import logger


class StageTimer:
    def __init__(self, device: Optional[torch.device] = None):
        self.device = device
        self.spans: List[Dict] = []

    @contextlib.contextmanager
    def span(self, name: str, nested: bool = False):
        """`nested=True` marks a span inside another span's wall time (a
        stage under the concurrent span): reported, but left out of the
        summary's total."""
        start = time.perf_counter()
        try:
            yield
        finally:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            self.spans.append({"name": name, "seconds": time.perf_counter() - start,
                               "nested": nested})

    def summary(self) -> Dict[str, float]:
        return {s["name"]: s["seconds"] for s in self.spans}

    def print_summary(self, title: str = "Timing") -> None:
        if not self.spans:
            return
        total = sum(s["seconds"] for s in self.spans if not s["nested"])
        logger.stage(f"{title} ({total:.2f}s total)")
        for s in self.spans:
            share = 100.0 * s["seconds"] / total if total else 0.0
            name = ("  ∟ " if s["nested"] else "") + s["name"]
            logger.info(f"{name:<32s} {s['seconds']:>8.2f}s  {share:5.1f}%")


def maybe_span(timer: Optional[StageTimer], name: str):
    """A nested span on `timer`, or a no-op when no timer is threaded
    through."""
    if timer is None:
        return contextlib.nullcontext()
    return timer.span(name, nested=True)


@contextlib.contextmanager
def trace(trace_dir: Optional[str] = None):
    """A `torch.profiler` trace (host, and the card when there is one)
    around a block, written as `trace.json` (Chrome trace format) to
    `trace_dir` or `$ETUDE_TRACE_DIR`; a no-op when neither names one."""
    trace_dir = trace_dir or os.environ.get("ETUDE_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(trace_dir) / "trace.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    logger.info(f"profiler trace → {out}")
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out))
