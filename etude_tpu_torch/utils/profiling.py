"""Named wall-clock spans (JAX counterpart: etude_tpu/utils/profiling.py
`StageTimer`, `maybe_span`). A span on a CUDA device ends with a
synchronize, so it holds the device work queued inside it."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch


class StageTimer:
    def __init__(self, device: Optional[torch.device] = None):
        self.device = device
        self.spans: List[Dict] = []

    @contextlib.contextmanager
    def span(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.spans.append({"name": name, "seconds": time.perf_counter() - start})

    def summary(self) -> Dict[str, float]:
        return {s["name"]: s["seconds"] for s in self.spans}


def maybe_span(timer: Optional[StageTimer], name: str):
    """A span on `timer`, or a no-op when no timer is threaded through."""
    if timer is None:
        return contextlib.nullcontext()
    return timer.span(name)
