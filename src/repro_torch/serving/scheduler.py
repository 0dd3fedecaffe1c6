"""Continuous-batching request queue with fifo / sjf admission.

Counterpart of ``repro.serving.scheduler`` (framework-free; the deadline
and remaining-work policies and preemption bookkeeping wait for the
frontend). Requests enter a queue and are admitted to a free decode lane
by the engine; a lane runs chunked prefill, decodes ``max_new`` tokens and
retires, freeing the lane for the next admission.

  * ``fifo`` — arrival order (default);
  * ``sjf``  — shortest-prompt-first (ties break on arrival order).
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
import time
from typing import Optional

import numpy as np

__all__ = ["Request", "Scheduler", "ADMISSION_POLICIES", "synthetic_prompts"]

ADMISSION_POLICIES = ("fifo", "sjf")


def synthetic_prompts(n, vocab, rng, lo=4, hi=24):
    """n int32 prompt arrays with lengths in [lo, hi) — the same
    distribution as the reference's generator, for the same numpy ``rng``."""
    return [
        rng.integers(0, vocab, int(rng.integers(lo, hi))).astype(np.int32)
        for _ in range(n)
    ]


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle timestamps:
    t_submit -> (queue) -> t_admit -> (prefill) -> t_first -> (decode) -> t_done."""

    rid: int
    prompt: np.ndarray  # int32 [L], L >= 1
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    margins: list = dataclasses.field(default_factory=list)  # top-2 logit gap per token
    t_submit: Optional[float] = None
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    status: str = "active"  # "active" | "done" | "cancelled" | "numeric_error"
    cancel_reason: Optional[str] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError("empty prompt")
        if self.max_new < 1:
            raise ValueError("max_new must be >= 1")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new


class Scheduler:
    """Admission queue: ``submit`` enqueues; ``pop`` yields the next request
    to bind to a freed lane under the configured policy."""

    def __init__(self, policy: str = "fifo"):
        if policy not in ADMISSION_POLICIES:
            raise ValueError(f"unknown admission policy {policy!r}; "
                             f"choose from {ADMISSION_POLICIES}")
        self.policy = policy
        self._fifo: collections.deque = collections.deque()
        self._heap: list = []
        self._seq = itertools.count()

    def submit(self, req: Request) -> Request:
        if req.t_submit is None:  # a re-submission keeps its arrival time
            req.t_submit = time.monotonic()
        if self.policy == "fifo":
            self._fifo.append(req)
        else:
            heapq.heappush(self._heap, (req.prompt_len, next(self._seq), req))
        return req

    def pop(self) -> Request | None:
        if self.policy == "fifo":
            return self._fifo.popleft() if self._fifo else None
        return heapq.heappop(self._heap)[2] if self._heap else None

    def remove(self, rid: int) -> Request | None:
        """Remove and return the queued request with this rid, or None."""
        for idx, r in enumerate(self._fifo):
            if r.rid == rid:
                del self._fifo[idx]
                return r
        for idx, (_, _, r) in enumerate(self._heap):
            if r.rid == rid:
                self._heap.pop(idx)
                heapq.heapify(self._heap)
                return r
        return None

    def __len__(self) -> int:
        return len(self._fifo) + len(self._heap)

    def __bool__(self) -> bool:
        return len(self) > 0
