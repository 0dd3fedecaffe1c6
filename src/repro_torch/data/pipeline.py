"""Input pipeline: host batches -> tensors on the device, with prefetch.

Counterpart of ``repro.data.pipeline``: a thread turns the next
``prefetch`` numpy batches into int64 tensors on the device while the
current step runs. Under a mesh (``mesh=``, or the active one for
``to_global``) every rank reads the same global batch and keeps its rows:
the batch dim split over the mesh's "pod" x "data" ranks, as the
reference's ``("batch", ...)`` sharding places it.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from ..distributed import sharding as shd
from ..optim.train_state import batch_to_device

__all__ = ["ShardedPipeline", "to_global"]

_END = object()


def to_global(batch: dict, mesh=None) -> dict:
    """This rank's rows of a global numpy batch: the batch dim split over
    the mesh's batch axes, rank-major (``sharding.batch_rank``); the whole
    batch without a mesh. Raises if the batch does not split evenly (the
    reference would then replicate it on every rank)."""
    mesh = mesh or shd.active_mesh()
    n = shd.batch_ranks(mesh)
    if n == 1:
        return batch
    i = shd.batch_rank(mesh)
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if v.shape[0] % n:
            raise ValueError(f"to_global: batch {k!r} of {v.shape[0]} rows over {n} ranks")
        rows = v.shape[0] // n
        out[k] = v[i * rows:(i + 1) * rows]
    return out


def _to_device(batch: dict, device: torch.device) -> dict:
    """``batch_to_device``; to the card through pinned memory with no wait,
    so the thread never waits for the device (nor holds the interpreter
    while the steps queued before the copy run)."""
    if device.type != "cuda":
        return batch_to_device(batch, device)
    return {k: torch.from_numpy(np.asarray(v, np.int64)).pin_memory().to(device, non_blocking=True)
            for k, v in batch.items()}


class ShardedPipeline:
    """Wraps a host-batch iterator with a prefetch thread and device
    placement (under ``mesh``, of this rank's rows: ``to_global``). An
    exception of the iterator reaches the consumer at the batch where it
    arose; the iterator's end ends this one; ``close()`` stops the
    thread."""

    def __init__(self, it: Iterator[dict], device="cpu", prefetch: int = 2, mesh=None):
        self._it = it
        self._device = torch.device(device)
        self._mesh = mesh
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, x) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(x, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self) -> None:
        try:
            for b in self._it:
                if self._stop.is_set() or not self._put(_to_device(to_global(b, self._mesh), self._device)):
                    return
            self._put(_END)
        except Exception as e:  # passed on to the consumer
            self._put(e)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        x = self._q.get()
        if x is _END:
            self._q.put(_END)  # every later call ends too
            raise StopIteration
        if isinstance(x, Exception):
            raise x
        return x

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
