"""Pinned host staging and side-stream uploads for the partition pipeline.

The JAX package's prefetch thread assembles a partition's stacked [S, L]
host columns while the query thread runs the previous partition, and the
query thread then pays only the ``device_put``. On a CUDA card the copy
itself can overlap too: :class:`Uploader` stacks each column straight into
a page-locked buffer drawn from a reused :class:`PinnedPool` (a fresh
``pin_memory()`` costs a ``cudaHostAlloc`` every call), starts a
``non_blocking`` host-to-device copy on a side stream and records an
event. :meth:`Staged.take` makes the consuming stream wait on that event
and marks the tensor as used there (``record_stream``), so the caching
allocator cannot hand its block to another tensor while the consumer still
reads it. A buffer goes back to the pool with the copy's event and is
written again only after that event completes.

Only the stacking is host work that may fail and be retried by the
consumer (the table assembles the column again on demand). Every CUDA
call's error propagates: nothing here falls back to a synchronous copy or
to the CPU.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

#: page-locked buffers the pool keeps for reuse (beyond it, returned
#: buffers are freed)
PINNED_POOL_BUFFERS = 16


class PinnedPool:
    """Reused page-locked byte buffers, by size. ``allocations`` counts the
    buffers it had to allocate (each a ``cudaHostAlloc``)."""

    def __init__(self):
        self.max_buffers = PINNED_POOL_BUFFERS
        self._free: Dict[int, List[Tuple[torch.Tensor, Optional[torch.cuda.Event]]]] = {}
        self._lock = threading.Lock()
        self.allocations = 0

    def take(self, nbytes: int) -> torch.Tensor:
        """A pinned uint8 buffer of ``nbytes``, free to write: a pooled
        one after its last copy finished, else a new one."""
        with self._lock:
            free = self._free.get(nbytes)
            hit = free.pop() if free else None
        if hit is not None:
            buf, ev = hit
            if ev is not None:
                ev.synchronize()
            return buf
        self.allocations += 1
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def give(self, buf: torch.Tensor, event: Optional[torch.cuda.Event]) -> None:
        """Return ``buf``; ``event`` marks the end of the copy that reads it."""
        with self._lock:
            if sum(len(v) for v in self._free.values()) < self.max_buffers:
                self._free.setdefault(buf.numel(), []).append((buf, event))

    def buffers(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._free.values())


class Staged:
    """A column uploaded on the side stream: the device tensor and the
    event its copy recorded."""

    __slots__ = ("tensor", "event")

    def __init__(self, tensor: torch.Tensor, event: torch.cuda.Event):
        self.tensor = tensor
        self.event = event

    def take(self) -> torch.Tensor:
        """The tensor, ordered after its copy on the current stream."""
        stream = torch.cuda.current_stream(self.tensor.device)
        stream.wait_event(self.event)
        self.tensor.record_stream(stream)
        return self.tensor


class Uploader:
    """Stacks host columns into pinned buffers and copies them to ``device``
    on a side stream (one per uploader)."""

    def __init__(self, device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"side-stream uploads need a CUDA device, not {device}")
        self.device = device
        self.pool = PinnedPool()
        self._stream: Optional[torch.cuda.Stream] = None
        #: bytes copied to the device by this uploader
        self.bytes = 0

    @property
    def stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        return self._stream

    def upload(self, shape: Tuple[int, ...], dtype: np.dtype,
               fill: Callable[[np.ndarray], None]) -> Optional[Staged]:
        """``fill`` writes the column into a pinned [shape] array; the copy
        to the device starts on the side stream. None when ``fill`` fails
        (host work the consumer redoes on demand)."""
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        buf = self.pool.take(nbytes)
        host = buf.numpy().view(dtype).reshape(shape)
        try:
            fill(host)
        except Exception:  # host assembly only; the consumer stacks it again
            self.pool.give(buf, None)
            return None
        with torch.cuda.stream(self.stream):
            dev = torch.empty(shape, dtype=torch.from_numpy(host[:0]).dtype,
                              device=self.device)
            dev.view(-1).view(torch.uint8).copy_(buf, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self.pool.give(buf, ev)
        self.bytes += nbytes
        return Staged(dev, ev)
