"""Host-to-device feeding with the copies of the next batches in flight.

Counterpart of ``dmlcloud_tpu/data/device.py`` (``device_iterator`` :56-113),
where ``jax.device_put`` is asynchronous and a prefetch depth of 2 hides the
transfer behind the step. On a CUDA device the same overlap takes three
things: pinned host memory (a copy from pageable memory is synchronous), a
copy stream of its own (a copy on the compute stream would queue behind the
step) and an event per batch that the consumer's stream waits on before it
reads the batch.

Two stages, both optional:

1. **Device prefetch** (``prefetch``, default 2): that many batches are
   copied ahead of the one handed out. ``prefetch=0`` copies each batch when
   it is asked for, nothing ahead.
2. **Host prefetch** (``host_prefetch``, default 0): the source iterator is
   read on a background thread through a bounded queue
   (``datasets._prefetch_iter``), so host-side batch preparation overlaps the
   training thread. CUDA calls stay on the consuming thread.
"""

from __future__ import annotations

import collections
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from ..telemetry import journal as _journal
from .datasets import _prefetch_iter

__all__ = ["device_iterator"]


def _map_tensors(batch: Any, fn) -> Any:
    """``batch`` (numpy arrays or tensors, possibly in a dict, list or tuple)
    with ``fn`` applied to each array as a tensor; other leaves unchanged."""
    if isinstance(batch, np.ndarray):
        return fn(torch.from_numpy(batch))
    if isinstance(batch, torch.Tensor):
        return fn(batch)
    if isinstance(batch, dict):
        return {k: _map_tensors(v, fn) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map_tensors(v, fn) for v in batch)
    return batch


def _tensors(batch: Any) -> Iterator[torch.Tensor]:
    if isinstance(batch, torch.Tensor):
        yield batch
    elif isinstance(batch, dict):
        for v in batch.values():
            yield from _tensors(v)
    elif isinstance(batch, (list, tuple)):
        for v in batch:
            yield from _tensors(v)


class _CudaCopier:
    """Pinned, non-blocking copies on one dedicated stream. ``put`` pins the
    host arrays (``pin_memory()`` raises if it cannot: there is no fallback to
    pageable copies), enqueues their copies on the copy stream and records an
    event after them; ``take`` makes the consumer's current stream wait on
    that event and marks every tensor as used by that stream, so that the
    caching allocator does not hand its memory out again while the step still
    reads it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)

    def _copy(self, t: torch.Tensor) -> torch.Tensor:
        if t.device == self.device:
            return t
        if t.device.type != "cpu":
            raise ValueError(f"device_iterator copies host batches to {self.device}, got a tensor on {t.device}")
        return t.pin_memory().to(self.device, non_blocking=True)

    def put(self, batch: Any) -> tuple[Any, torch.cuda.Event]:
        with torch.cuda.stream(self.stream):
            out = _map_tensors(batch, self._copy)
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    def take(self, item: tuple[Any, torch.cuda.Event]) -> Any:
        batch, event = item
        current = torch.cuda.current_stream(self.device)
        current.wait_event(event)
        for t in _tensors(batch):
            if t.device == self.device:
                t.record_stream(current)
        return batch


class _HostCopier:
    """The CPU device: a plain transfer (``torch.from_numpy``), no stream, no
    pinning."""

    def __init__(self, device: torch.device):
        self.device = device

    def put(self, batch: Any) -> Any:
        return _map_tensors(batch, lambda t: t.to(self.device))

    def take(self, item: Any) -> Any:
        return item


def device_iterator(
    it: Iterable[Any],
    device: str | torch.device,
    prefetch: int = 2,
    host_prefetch: int = 0,
) -> Iterator[Any]:
    """Yield the batches of ``it`` on ``device``, with ``prefetch`` copies in
    flight ahead of the one handed out and, with ``host_prefetch > 0``, that
    many host batches read ahead on a background thread.

    Each copy's dispatch is an ``h2d`` journal span. Closing the generator
    (``close()``, or abandoning it) closes the host reader, whose thread then
    exits within one queue timeout: the preemption drain relies on it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    copier = _CudaCopier(device) if device.type == "cuda" else _HostCopier(device)
    src = _prefetch_iter(iter(it), host_prefetch) if host_prefetch > 0 else iter(it)
    try:
        if prefetch <= 0:
            for batch in src:
                with _journal.span("h2d", prefetch=0):
                    item = copier.put(batch)
                yield copier.take(item)
            return

        queue: collections.deque = collections.deque()

        def enqueue(n: int) -> None:
            for _ in range(n):
                try:
                    batch = next(src)
                except StopIteration:
                    return
                # the span covers the dispatch of the copy; the copy itself
                # runs on the copy stream while the device computes
                with _journal.span("h2d", prefetch=prefetch):
                    queue.append(copier.put(batch))

        enqueue(prefetch)
        while queue:
            yield copier.take(queue.popleft())
            enqueue(1)
    finally:
        close = getattr(src, "close", None)
        if close is not None:
            close()
