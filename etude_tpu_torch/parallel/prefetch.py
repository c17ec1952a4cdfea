"""Asynchronous host→device input pipeline (JAX counterpart:
etude_tpu/parallel/prefetch.py).

A background thread builds the numpy batches, reshapes them to
[accum, B/accum, T] (under a mesh, keeps this rank's rows of them), pins
them and copies them to the card on a stream of its own, ahead of use; the
consumer's stream waits on each batch's copy event, and each tensor is
recorded on the consumer's stream so the allocator keeps its memory until
the step that reads it is done. On the CPU the same
thread hands over plain tensors.

`prefetch` is the auxiliary models' host pipeline (scripts/
train_aux_synthetic.py :49): batches built by worker threads, steps striped
over them.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from .mesh import shard_batch
from .train_step import reshape_for_accum


class DevicePrefetcher:
    """Wrap a host batch iterator; yields `place(batch)` for each batch,
    built up to `buffer_size` batches ahead on a background thread.

    buffer_size=2 gives double buffering: while the consumer runs step t,
    batch t+1 is ready and t+2 is being built. `close()` stops the thread
    when the consumer leaves early (a step cap)."""

    def __init__(
        self,
        batch_iter: Iterator[Dict[str, np.ndarray]],
        place: Optional[Callable] = None,
        buffer_size: int = 2,
    ):
        self._iter = batch_iter
        self._place = place or (lambda b: b)
        self._queue: queue.Queue = queue.Queue(maxsize=buffer_size)
        self._done = object()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for batch in self._iter:
                if not self._put(self._place(batch)):
                    return
        except BaseException as exc:  # propagated to the consumer
            self._error = exc
        finally:
            self._put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._done:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=60)
        if self._thread.is_alive():
            raise RuntimeError("the prefetch thread did not stop")


class _OnStream:
    """Batches copied on a side stream, handed to the consumer's stream."""

    def __init__(self, prefetcher: DevicePrefetcher, device: torch.device):
        self._prefetcher = prefetcher
        self._device = device

    def __iter__(self):
        return self

    def __next__(self):
        batch, copied = next(self._prefetcher)
        stream = torch.cuda.current_stream(self._device)
        stream.wait_event(copied)
        for t in batch.values():
            t.record_stream(stream)
        return batch

    def close(self) -> None:
        self._prefetcher.close()


def _prefetch(batch_iter, device, host_fn):
    """`host_fn(batch)` of each host batch as tensors on `device`, built on a
    background thread and, on the card, copied on a side stream."""
    device = torch.device(device)

    def to_tensors(batch):
        return {k: torch.from_numpy(v) for k, v in host_fn(batch).items()}

    if device.type != "cuda":
        return DevicePrefetcher(batch_iter, place=to_tensors)
    copy_stream = torch.cuda.Stream(device)

    def place(batch):
        with torch.cuda.stream(copy_stream):
            out = {k: v.pin_memory().to(device, non_blocking=True)
                   for k, v in to_tensors(batch).items()}
            copied = torch.cuda.Event()
            copied.record(copy_stream)
        return out, copied

    return _OnStream(DevicePrefetcher(batch_iter, place=place), device)


def prefetch_to_device(batch_iter, device, accum_steps: int):
    """The single-device counterpart of the JAX package's
    `prefetch_to_mesh` (:64): [B, T] host batches become [accum, B/accum, T]
    tensors on `device`, built and copied ahead of use. Call `close()` when
    leaving before the iterator is exhausted."""
    return _prefetch(batch_iter, device, lambda b: reshape_for_accum(b, accum_steps))


def prefetch_to_mesh(batch_iter, mesh, accum_steps: int):
    """The JAX package's `prefetch_to_mesh` (:64) for one rank: every rank
    iterates the dataset in the same seeded order and, of each [B, T] host
    batch reshaped to [accum, B/accum, T], keeps its rows of every
    micro-batch and the micro-batches' global label counts
    (`mesh.shard_batch`), built and copied to `mesh.device` ahead of use.
    Call `close()` when leaving before the iterator is exhausted."""
    return _prefetch(batch_iter, mesh.device,
                     lambda b: shard_batch(reshape_for_accum(b, accum_steps), mesh))


def prefetch(gen_fn: Callable[[int], Any], n_steps: int, depth: int = 4,
             workers: int = 1) -> Iterator[Any]:
    """Yields `gen_fn(i)` for `n_steps` steps, built up to `depth` ahead on
    `workers` daemon threads. With workers > 1, worker w builds steps w,
    w + workers, ..., and batches may arrive out of order: a `gen_fn` that
    draws from one shared generator then gives an order that no seed
    reproduces (the JAX script's semantics, kept). An exception in `gen_fn`
    is raised in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    failed = object()

    def worker(w):
        try:
            for i in range(w, n_steps, workers):
                q.put(gen_fn(i))
        except BaseException as exc:  # handed to the consumer
            q.put((failed, exc))

    for w in range(workers):
        threading.Thread(target=worker, args=(w,), daemon=True).start()
    for _ in range(n_steps):
        item = q.get()
        if isinstance(item, tuple) and len(item) == 2 and item[0] is failed:
            raise item[1]
        yield item
