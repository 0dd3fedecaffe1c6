"""Input pipeline: host batches -> tensors on the device, with prefetch.

Counterpart of ``repro.data.pipeline.ShardedPipeline`` on one device: a
thread turns the next ``prefetch`` numpy batches into int64 tensors on the
device while the current step runs. The reference's ``mesh`` argument (the
batch dimension sharded over the pod and data axes) has no meaning on one
card and is dropped.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from ..optim.train_state import batch_to_device

__all__ = ["ShardedPipeline"]

_END = object()


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
    placement. An exception of the iterator reaches the consumer at the
    batch where it arose; the iterator's end ends this one; ``close()``
    stops the thread."""

    def __init__(self, it: Iterator[dict], device="cpu", prefetch: int = 2):
        self._it = it
        self._device = torch.device(device)
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
                if self._stop.is_set() or not self._put(_to_device(b, self._device)):
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
