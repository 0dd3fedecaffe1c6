"""Continuous-batching request queue with pluggable admission policies.

Counterpart of ``repro.serving.scheduler`` (framework-free): the same
policies, ``Request`` fields and prompt generators, which draw the same
prompts for the same numpy ``rng``. The port's ``Request`` also keeps each
generated token's top-2 logit gap in ``margins``.

Requests enter a queue and are *admitted* to a free decode lane by the
engine; a lane runs chunked prefill over the request's prompt, then decodes
until ``max_new`` tokens are emitted, then retires and frees the lane for
the next admission — other lanes never stall.

Admission policies:
  * ``fifo`` — arrival order (fair, default);
  * ``sjf``  — shortest-prompt-first (minimizes mean time-to-first-token
    when prompt lengths are skewed; classic shortest-job-first trade-off:
    long prompts can starve under sustained load);
  * ``edf``  — earliest-deadline-first (deadline-aware admission for the
    multi-tenant frontend; requests without a deadline sort last, ties
    break on arrival order);
  * ``sjf_work`` — shortest-*remaining-work*-first: sorts on the estimated
    device-token cost still ahead of the request, counting prompt tokens a
    prefix-cache hit would skip (``work_hint``, stamped by the router at
    submission) and prompt/output tokens already consumed (a preempted
    request re-entering the queue owes only its remaining decode). This is
    the scheduler-v2 policy for the warm-cache tail: a warm full hit costs
    ~``max_new`` tokens while a cold long prompt costs ``prompt + max_new``,
    and FIFO makes the cheap request wait behind the expensive one.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
import time
from typing import Optional

import numpy as np

__all__ = [
    "Request",
    "Scheduler",
    "ADMISSION_POLICIES",
    "synthetic_prompts",
    "zipf_prefix_prompts",
]

ADMISSION_POLICIES = ("fifo", "sjf", "edf", "sjf_work")


def synthetic_prompts(n, vocab, rng, lo=4, hi=24):
    """Synthetic request workload: n int32 prompt arrays with lengths in
    [lo, hi). Shared by the serve CLI, the smoke script and the tests so
    they always sample the same distribution."""
    return [
        rng.integers(0, vocab, int(rng.integers(lo, hi))).astype(np.int32)
        for _ in range(n)
    ]


def zipf_prefix_prompts(
    n,
    vocab,
    rng,
    n_prefixes=4,
    prefix_len=24,
    suffix_lo=2,
    suffix_hi=10,
    alpha=1.1,
    prefix_seed=None,
):
    """Shared-system-prompt workload: each prompt is ``prefix + suffix``
    where the prefix is drawn zipf(alpha)-style from ``n_prefixes`` fixed
    "system prompts" of length ``prefix_len`` and the suffix is a fresh
    uniform sample of length in [suffix_lo, suffix_hi).

    This is the distribution the frontend's LSTM-state prefix cache exists
    for: the hot prefixes repeat across requests (and across tenants), so a
    cached ``(h, c)`` snapshot at the prefix boundary turns most of each
    prompt's prefill into a single state injection. Deterministic for a
    fixed ``rng``. Pass ``prefix_seed`` to pin the prefix pool
    independently of ``rng``: a warm-up workload and a measurement workload
    built with the same ``prefix_seed`` but different ``rng`` seeds share
    their system prompts while every suffix is fresh — the honest version
    of a warm cache.
    """
    prng = np.random.default_rng(prefix_seed) if prefix_seed is not None else rng
    prefixes = [
        prng.integers(0, vocab, prefix_len).astype(np.int32)
        for _ in range(n_prefixes)
    ]
    ranks = np.arange(1, n_prefixes + 1, dtype=np.float64)
    probs = ranks**-alpha
    probs /= probs.sum()
    prompts = []
    for _ in range(n):
        k = int(rng.choice(n_prefixes, p=probs))
        suffix = rng.integers(
            0, vocab, int(rng.integers(suffix_lo, suffix_hi))
        ).astype(np.int32)
        prompts.append(np.concatenate([prefixes[k], suffix]))
    return prompts


@dataclasses.dataclass
class Request:
    """One generation request plus its lifecycle timestamps.

    The four timestamps split a request's wall-clock into the three phases
    the observability layer attributes latency to (see ``phases``):

        t_submit ──queue──▶ t_admit ──prefill──▶ t_first ──decode──▶ t_done

    ``t_submit`` is stamped once at first scheduler submission (preserved
    across router→engine resubmission), ``t_admit`` when the engine binds
    the request to a lane, ``t_first`` at the first generated token, and
    ``t_done`` at retire.
    """

    rid: int
    prompt: np.ndarray  # int32 [L], L >= 1
    max_new: int
    tenant: str = "default"
    deadline: Optional[float] = None  # absolute time.monotonic() deadline
    out: list = dataclasses.field(default_factory=list)
    margins: list = dataclasses.field(default_factory=list)  # top-2 logit gap per token
    t_submit: Optional[float] = None
    t_admit: Optional[float] = None  # bound to a lane (queue wait ends)
    t_first: Optional[float] = None  # first generated token (TTFT anchor)
    t_done: Optional[float] = None
    cache_hit: bool = False  # prefix-cache hit at admission
    cache_saved_tokens: int = 0  # prompt tokens skipped via state injection
    cache_saved_steps: int = 0  # ... as whole prefill steps at engine chunk
    # "active" | "done" | "cancelled" | "numeric_error"
    status: str = "active"
    cancel_reason: Optional[str] = None  # set iff cancelled or numeric_error
    work_hint: Optional[int] = None  # prefix-cache match length, if probed
    preempt_count: int = 0  # times this request was preempted off a lane

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

    @property
    def cancelled(self) -> bool:
        return self.status == "cancelled"

    def remaining_work(self) -> int:
        """Estimated device-token cost still ahead: unconsumed prompt
        tokens (minus the cached prefix the router probed into
        ``work_hint``) plus undecoded output tokens. Once decoding has
        started the prompt is fully paid for, so a preempted request owes
        only its remaining decode."""
        remaining_out = max(self.max_new - len(self.out), 0)
        if self.out:
            return remaining_out
        cached = self.work_hint if self.work_hint is not None else 0
        return max(self.prompt_len - cached, 0) + remaining_out

    def phases(self) -> Optional[dict]:
        """Per-request latency breakdown in milliseconds, or None until the
        request retires (queue, prefill and decode, as the metrics split a
        request's latency); each phase is clamped at 0 so clock-read
        ordering noise can never produce a negative duration."""
        if self.t_submit is None or self.t_done is None:
            return None
        t0 = self.t_submit
        t_admit = self.t_admit if self.t_admit is not None else t0
        t1 = self.t_first if self.t_first is not None else self.t_done
        return {
            "queue_ms": max(t_admit - t0, 0.0) * 1e3,
            "prefill_ms": max(t1 - t_admit, 0.0) * 1e3,
            "decode_ms": max(self.t_done - t1, 0.0) * 1e3,
            "total_ms": max(self.t_done - t0, 0.0) * 1e3,
            "cache_hit": self.cache_hit,
            "cache_saved_tokens": self.cache_saved_tokens,
            "cache_saved_steps": self.cache_saved_steps,
        }

    def sort_key(self, policy: str) -> float:
        if policy == "sjf":
            return float(self.prompt_len)
        if policy == "sjf_work":
            return float(self.remaining_work())
        # edf: missing deadline == infinitely lax, served after all dated work
        return self.deadline if self.deadline is not None else float("inf")


class Scheduler:
    """Admission queue. ``submit`` enqueues; ``pop`` yields the next request
    to bind to a freed lane under the configured policy."""

    def __init__(self, policy: str = "fifo"):
        if policy not in ADMISSION_POLICIES:
            raise ValueError(f"unknown admission policy {policy!r}; "
                             f"choose from {ADMISSION_POLICIES}")
        self.policy = policy
        self._fifo: collections.deque = collections.deque()
        self._heap: list = []
        self._seq = itertools.count()

    def submit(self, req: Request, now: float | None = None) -> Request:
        # first submission stamps arrival; re-submission (router queue ->
        # engine queue) must NOT erase the time already spent waiting, or
        # TTFT/latency would exclude router queueing exactly under the
        # backlog conditions they exist to expose
        if req.t_submit is None:
            req.t_submit = time.monotonic() if now is None else now
        if self.policy == "fifo":
            self._fifo.append(req)
        else:  # sjf/edf: stable tie-break on arrival order
            heapq.heappush(
                self._heap, (req.sort_key(self.policy), next(self._seq), req)
            )
        return req

    def pop(self) -> Request | None:
        if self.policy == "fifo":
            return self._fifo.popleft() if self._fifo else None
        if self._heap:
            return heapq.heappop(self._heap)[2]
        return None

    def peek(self) -> Request | None:
        """Next request ``pop`` would return, without removing it — the
        engine's preemption check compares its remaining work against the
        lanes' without committing to an admission."""
        if self.policy == "fifo":
            return self._fifo[0] if self._fifo else None
        return self._heap[0][2] if self._heap else None

    def remove(self, rid: int) -> Request | None:
        """Remove and return the queued request with this rid, or None.
        O(queue) scan + (heap policies) re-heapify — cancellation is rare
        relative to queue churn and queues are bounded small, so linear
        cost beats maintaining a rid index on the hot submit/pop path."""
        for idx, r in enumerate(self._fifo):
            if r.rid == rid:
                del self._fifo[idx]
                return r
        for idx, (_, _, r) in enumerate(self._heap):
            if r.rid == rid:
                last = self._heap.pop()
                if idx < len(self._heap):
                    self._heap[idx] = last
                    heapq.heapify(self._heap)
                return r
        return None

    def __len__(self) -> int:
        return len(self._fifo) + len(self._heap)

    def __bool__(self) -> bool:
        return len(self) > 0
