"""Double-buffered host -> device prefetch.

Counterpart of `clip_dplm_tpu/data/prefetch.py`: one background thread runs
the host batch iterator (so collation, and the native tokenizer where a
loader calls it, happen on that thread) and places the NEXT batch on the
device while the device runs the current step. As in the JAX package it is
one thread, not a process pool.

On a CUDA device the worker pins each array (`pin_memory`) and copies it
with `non_blocking=True` on a `torch.cuda.Stream` of its own, then records
an event. `__next__` makes the consumer's current stream wait on that event,
so a step never reads a batch whose copy has not landed, and calls
`record_stream(consumer stream)` on every tensor, so the caching allocator
does not hand the batch's memory to a later copy while the step still reads
it. On the CPU there is no stream and no pinning: the worker converts each
array with `torch.as_tensor`. A plain int (a graph batch's `num_graphs`)
passes through as `train/trainer.py::to_device` passes it.

The worker's semantics are the JAX package's one for one: the thread holds
a `_WorkerState`, never the prefetcher, so `weakref.finalize` can reap an
iterator the consumer dropped without `close()`; the `_DONE` sentinel reaches
the consumer even when the queue is full; an error raised in the host
iterator or the copy is raised again in the consumer.
"""

from __future__ import annotations

import queue
import threading
import time
import weakref
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch


class _WorkerState:
    """Everything the worker thread touches, kept apart from the public
    wrapper: the thread must NOT hold a reference to the DevicePrefetcher,
    or the weakref.finalize that reaps abandoned iterators could never fire
    and the worker would poll queue.Full at 10 Hz forever."""

    __slots__ = ("queue", "stop", "error", "device", "transform", "stream")

    def __init__(self, depth, device, transform, stream):
        self.queue: queue.Queue = queue.Queue(maxsize=depth)
        self.stop = threading.Event()
        self.error: Optional[BaseException] = None
        self.device = device
        self.transform = transform
        self.stream = stream


_DONE = object()


def _to_tensor(x, device: torch.device, pin: bool):
    if isinstance(x, int):
        return x
    t = torch.as_tensor(np.ascontiguousarray(x) if isinstance(x, np.ndarray) else x)
    if pin and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=pin)


def _put_device(state: _WorkerState, batch):
    """(device batch, event or None): the batch's arrays on the device,
    copied on the worker's stream with an event recorded after them."""
    if state.transform is not None:
        batch = state.transform(batch)
    if state.stream is None:
        return {k: _to_tensor(v, state.device, False) for k, v in batch.items()}, None
    with torch.cuda.stream(state.stream):
        out = {k: _to_tensor(v, state.device, True) for k, v in batch.items()}
        event = torch.cuda.Event()
        event.record(state.stream)
    return out, event


def _worker(state: _WorkerState, it):
    try:
        for batch in it:
            if state.stop.is_set():
                return
            out = _put_device(state, batch)
            while not state.stop.is_set():
                try:
                    state.queue.put(out, timeout=0.1)
                    break
                except queue.Full:
                    continue
    except BaseException as e:  # raised again in the consumer
        state.error = e
    finally:
        # a blocking put (bounded by the stop flag): the sentinel MUST
        # reach the consumer on normal exhaustion even when the queue is
        # full, or __next__ blocks forever
        while True:
            try:
                state.queue.put(_DONE, timeout=0.1)
                break
            except queue.Full:
                if state.stop.is_set():
                    break


def _reap(state: _WorkerState) -> None:
    """close() body and weakref.finalize target: stop the worker and drop
    the queued device batches."""
    state.stop.set()
    try:
        while True:
            state.queue.get_nowait()
    except queue.Empty:
        pass


class DevicePrefetcher:
    """Wrap a host batch iterator (dicts of numpy arrays, tensors or ints);
    yields dicts of tensors on `device`, keeping `depth` batches in flight.
    `transform` runs on each host batch on the worker thread first.
    `wait_seconds` sums the time `__next__` waited for the worker."""

    def __init__(self, batches: Iterable, device=None, depth: int = 2,
                 transform: Optional[Callable] = None):
        device = torch.device("cpu" if device is None else device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.device = device
        self.wait_seconds = 0.0
        self._state = _WorkerState(depth, device, transform, stream)
        self._thread = threading.Thread(
            target=_worker, args=(self._state, iter(batches)), daemon=True)
        self._thread.start()
        # a consumer that drops the iterator without close() (breaks out
        # of a prefetch_to_device loop) has its worker reaped at GC time
        self._finalizer = weakref.finalize(self, _reap, self._state)

    def close(self) -> None:
        """Stop the worker early (the consumer leaves the iterator, e.g. on
        preemption) and unblock it if it waits on a full queue."""
        self._finalizer()

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        t0 = time.perf_counter()
        item = self._state.queue.get()
        self.wait_seconds += time.perf_counter() - t0
        if item is _DONE:
            if self._state.error is not None:
                raise self._state.error
            raise StopIteration
        batch, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for v in batch.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(consumer)
        return batch


def prefetch_to_device(batches: Iterable, device=None, depth: int = 2) -> DevicePrefetcher:
    """`for batch in prefetch_to_device(loader, device): ...`"""
    return DevicePrefetcher(batches, device=device, depth=depth)
