"""Multi-tenant async request router over ServeEngine replicas.

Counterpart of ``repro.serving.frontend.router``, without the
``drop_expired`` switch nothing turns off: expired requests are always
dropped. The HTTP layer (``serving/http/server.py``) reads it through
``AsyncRouter.snapshot`` (``Router.scrape`` for /metrics, with the kernel
cost ledger's rows), cancels through ``AsyncRouter.cancel`` and counts its
admission retries with ``Router.note_retry``; ``pump`` emits the ledger's
``cost.<op>`` counter tracks while the tracer is on.

The router is the traffic layer the ROADMAP's "millions of users" story
needs above the batching engine: requests arrive asynchronously, are
admitted through a bounded queue under a deadline-aware policy, dispatched
to the least-loaded engine replica, streamed back token by token, and
accounted per tenant. All engine replicas share one FP8 LSTM-state prefix
cache (see prefix_cache.py), so a prefix warmed by any replica accelerates
every replica.

Lifecycle of a submission:

  submit(prompt, tenant, deadline, on_token)
        │  validation / backpressure: reject-with-reason
        │  ("queue_full" | "tenant_quota" | "bad_request"), never raises
        ▼
  [bounded router queue]  — Scheduler policy: fifo | sjf | edf
        │  _dispatch(): expired deadlines rejected ("deadline_expired"),
        │  otherwise enqueued on the least-loaded replica with a free lane
        ▼
  engine replica: prefix-cache admission → chunked prefill → decode
        │  pump() advances every replica one batched step and delivers
        │  new tokens to each ticket's on_token callback
        ▼
  ticket.status == "done"  (tokens in ticket.tokens)

Cancellation: ``cancel(rid)`` (or an abandoned stream / a deadline that
expires mid-flight, both detected at the top of ``pump()``) removes the
request wherever it lives — router queue, engine queue, or a bound lane
(``ServeEngine.cancel`` folds the lane release into the step's reset
mask) — and flips the ticket to "cancelled" with a reason.

``Router.pump()`` is non-blocking-style single-stepping (drive it from any
event loop); ``drain()`` runs to completion; ``AsyncRouter`` wraps the
pump in asyncio for genuinely concurrent ``await generate(...)`` /
``async for tok in stream(...)`` clients, stepping the engines from a
worker thread (each engine steps on its own device, whatever the thread).
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np

from ...faults import FAULTS, ReplicaCrash
from ...kernels import dispatch as kernel_dispatch
from ...obs.trace import TRACER
from ..engine import ServeEngine
from ..metrics import LatencyHistogram, phase_summary, tenant_summary
from ..scheduler import Request, Scheduler

__all__ = ["Ticket", "Router", "AsyncRouter", "RequestRejected"]

REJECT_REASONS = (
    "queue_full", "tenant_quota", "bad_request", "deadline_expired",
    "no_healthy_replicas",
)


class RequestRejected(RuntimeError):
    """Raised by the asyncio streaming facade when admission rejects a
    submission; carries the rejected Ticket so callers (e.g. the HTTP
    layer) can map ``ticket.reason`` to a wire-level error."""

    def __init__(self, ticket: "Ticket"):
        super().__init__(f"request rejected: {ticket.reason}")
        self.ticket = ticket


@dataclasses.dataclass
class Ticket:
    """Caller-facing handle for one submission."""

    rid: int
    tenant: str
    # "queued" | "running" | "done" | "rejected" | "cancelled"
    # | "numeric_error" (the engine's nonfinite-logit guard retired it:
    # partial tokens are valid, the poisoned lane state was reset)
    status: str
    reason: Optional[str] = None  # set iff rejected/cancelled/numeric_error
    req: Optional[Request] = None
    on_token: Optional[Callable[[int], None]] = None
    sent: int = 0  # tokens already delivered to on_token
    t_done: Optional[float] = None
    abandoned: bool = False  # consumer gone: stop driving on its behalf

    @property
    def tokens(self) -> list:
        return list(self.req.out) if self.req is not None else []

    @property
    def ok(self) -> bool:
        return self.status != "rejected"


class Router:
    """Multi-tenant admission + dispatch over ServeEngine replicas.

    Lifecycle per submission: ``submit`` (non-blocking, reject-with-reason
    under backpressure) → bounded Scheduler queue → ``_dispatch`` to the
    least-loaded replica with a free lane → engine admission (prefix-cache
    lookup → ``StatePool.inject`` → chunked prefill from the match point)
    → per-token delivery via ``_deliver`` → ticket ``done``.

    Concurrency contract: the Router is **not thread-safe** and performs
    no internal locking. ``submit``/``pump``/``drain``/``report`` must be
    called from one thread at a time — either a single-threaded caller
    (the CLI's ``drain()`` loop) or externally serialized, which is
    exactly what ``AsyncRouter`` provides (one asyncio lock around every
    mutation, pumps executed in a worker thread while holding it).
    ``pump()`` itself never blocks on the network; one call is one
    scheduling round (dispatch + one batched device step per busy replica
    + token delivery), so callers control latency/throughput trade-offs
    by how often they pump.
    """

    def __init__(
        self,
        engines: Sequence[ServeEngine],
        max_queue: int = 64,
        admission: str = "edf",
        tenant_quota: Optional[int] = None,
        eject_after: int = 3,
        probe_every: int = 8,
    ):
        if not engines:
            raise ValueError("Router needs at least one engine replica")
        self.engines = list(engines)
        self.max_queue = max_queue
        self.tenant_quota = tenant_quota
        self._queue = Scheduler(admission)
        self._queued_by_tenant: dict[str, int] = {}
        self._tickets: dict[int, Ticket] = {}
        self._inflight: dict[int, Ticket] = {}  # queued or running
        self._rid = 0
        self.tenants: dict[str, dict] = {}  # per-tenant accounting
        self.rejections: dict[str, int] = {}
        # post-admission terminations by reason:
        # "client_cancel" (explicit cancel/DELETE), "abandoned"
        # (streaming consumer disconnected), "deadline_expired" (mid-flight)
        self.cancellations: dict[str, int] = {}
        # -- per-replica health -------------------------------------------
        # A replica is ejected after `eject_after` consecutive step
        # failures (immediately on ReplicaCrash); ejected replicas are
        # probed every `probe_every` pumps and reinstated when a probe
        # step succeeds. Its live requests are resubmitted to the healthy
        # pool with their original t_submit (honest latency accounting)
        # and deduplicated delivery via each ticket's `sent` cursor.
        self.eject_after = eject_after
        self.probe_every = probe_every
        self._health = [
            {"healthy": True, "consecutive_failures": 0,
             "pumps_since_probe": 0, "last_error": None}
            for _ in self.engines
        ]
        self.ejections = 0
        self.reinstatements = 0
        self.resubmits = 0
        self.retries = 0  # admission retries noted by the HTTP layer
        for i, e in enumerate(self.engines):
            e.replica = i  # fault-rule / trace identity
            if e.metrics.t_start is None:
                e.metrics.start()

    @classmethod
    def build(
        cls,
        model,
        params,
        policy,
        replicas: int = 1,
        prefix_cache=None,
        router_kw: Optional[dict] = None,
        **engine_kw,
    ) -> "Router":
        """Convenience: `replicas` ServeEngines sharing one prefix cache."""
        engines = [
            ServeEngine(model, params, policy, prefix_cache=prefix_cache, **engine_kw)
            for _ in range(replicas)
        ]
        return cls(engines, **(router_kw or {}))

    # -- intake ----------------------------------------------------------
    def _tenant(self, name: str) -> dict:
        return self.tenants.setdefault(
            name,
            {"submitted": 0, "rejected": 0, "completed": 0, "tokens": 0},
        )

    def _reject(self, ticket: Ticket, reason: str) -> Ticket:
        ticket.status = "rejected"
        ticket.reason = reason
        self._tenant(ticket.tenant)["rejected"] += 1
        self.rejections[reason] = self.rejections.get(reason, 0) + 1
        self._inflight.pop(ticket.rid, None)
        self._tickets.pop(ticket.rid, None)  # caller holds the Ticket
        return ticket

    def submit(
        self,
        prompt,
        max_new: int = 32,
        tenant: str = "default",
        deadline: Optional[float] = None,
        on_token: Optional[Callable[[int], None]] = None,
    ) -> Ticket:
        """Non-blocking admission. Always returns a Ticket; overload and
        malformed input reject with a reason instead of raising."""
        rid = self._rid
        self._rid += 1
        ticket = Ticket(rid=rid, tenant=tenant, status="queued", on_token=on_token)
        self._tickets[rid] = ticket
        self._tenant(tenant)["submitted"] += 1
        if deadline is not None and time.monotonic() > deadline:
            return self._reject(ticket, "deadline_expired")  # dead on arrival
        if not any(h["healthy"] for h in self._health):
            # circuit breaker: every replica is ejected — fail fast with a
            # distinct reason instead of queueing work nobody can serve
            # (retry-with-backoff upstream is only worth it while at least
            # one healthy replica remains)
            return self._reject(ticket, "no_healthy_replicas")
        if len(self._queue) >= self.max_queue:
            # before bouncing a serviceable request, drop queued work whose
            # deadline already passed — under saturation the backlog is
            # where requests expire, and dead work must not hold the slots
            # that backpressure is rationing
            self._purge_expired()
        if len(self._queue) >= self.max_queue:
            return self._reject(ticket, "queue_full")
        if (
            self.tenant_quota is not None
            and self._queued_by_tenant.get(tenant, 0) >= self.tenant_quota
        ):
            return self._reject(ticket, "tenant_quota")
        try:
            req = Request(
                rid=rid,
                prompt=np.asarray(prompt),
                max_new=max_new,
                tenant=tenant,
                deadline=deadline,
            )
        except (ValueError, TypeError):
            return self._reject(ticket, "bad_request")
        ticket.req = req
        if self.prefix_cache is not None:
            # what the "sjf_work" policy sorts on: the cached prefix makes
            # remaining work knowable at admission time. Non-mutating probe
            # — queue inspection must not warm the cache LRU.
            req.work_hint = self.prefix_cache.match_len(req.prompt)
        self._queue.submit(req)
        self._queued_by_tenant[tenant] = self._queued_by_tenant.get(tenant, 0) + 1
        self._inflight[rid] = ticket
        if TRACER.enabled:
            TRACER.instant(
                "router.submit", cat="router", rid=rid, tenant=tenant,
                queued=len(self._queue),
            )
        return ticket

    # -- dispatch / progress ---------------------------------------------
    def _purge_expired(self) -> None:
        """Drop queued requests whose deadline has passed (reject with
        "deadline_expired"). O(queue), so only called when the queue is
        actually under pressure."""
        now = time.monotonic()
        keep = []
        while self._queue:
            req = self._queue.pop()
            self._queued_by_tenant[req.tenant] -= 1
            if req.deadline is not None and now > req.deadline:
                self._reject(self._tickets[req.rid], "deadline_expired")
            else:
                keep.append(req)
        for req in keep:  # re-submit preserves t_submit and policy order
            self._queue.submit(req)
            self._queued_by_tenant[req.tenant] += 1

    def _dispatch(self) -> None:
        while self._queue:
            # An engine can absorb at most free_lanes requests before its
            # next step arms them; past that, handing it more would just
            # move the backlog into its internal FIFO — where the router's
            # admission policy, deadline dropping, and max_queue
            # backpressure no longer apply. Keep the excess here.
            free = [
                e for i, e in enumerate(self.engines)
                if self._health[i]["healthy"]
                and e.free_lanes > len(e.scheduler)
            ]
            if not free:
                return
            req = self._queue.pop()
            self._queued_by_tenant[req.tenant] -= 1
            ticket = self._tickets[req.rid]
            if req.deadline is not None and time.monotonic() > req.deadline:
                self._reject(ticket, "deadline_expired")
                continue
            # least-loaded balancing; ties go to the lowest replica index
            eng = min(free, key=lambda e: (e.load, self.engines.index(e)))
            eng.enqueue(req)
            ticket.status = "running"
            if TRACER.enabled:
                TRACER.instant(
                    "router.dispatch", cat="router", rid=req.rid,
                    replica=self.engines.index(eng),
                    queue_wait_ms=(
                        (time.monotonic() - req.t_submit) * 1e3
                        if req.t_submit is not None else 0.0
                    ),
                )

    # -- cancellation ----------------------------------------------------
    def cancel(self, rid: int, reason: str = "client_cancel") -> bool:
        """Terminally cancel an admitted request: queued at the router →
        scheduler removal; dispatched → ``ServeEngine.cancel`` (scheduler
        removal or masked lane release). Idempotent — unknown, finished,
        or rejected rids return False. The ticket flips to "cancelled"
        with the reason, and whatever tokens were already generated stay
        readable on it."""
        ticket = self._tickets.get(rid)
        if ticket is None or ticket.status in (
            "done", "rejected", "cancelled", "numeric_error"
        ):
            return False
        if ticket.status == "queued":
            req = self._queue.remove(rid)
            if req is None:
                return False  # submit raced a pump; next pump settles it
            self._queued_by_tenant[req.tenant] -= 1
            req.status = "cancelled"
            req.cancel_reason = reason
        elif not any(e.cancel(rid, reason=reason) for e in self.engines):
            return False  # retired this very pump round; ticket flips in _deliver
        ticket.status = "cancelled"
        ticket.reason = reason
        ticket.t_done = time.monotonic()
        ticket.on_token = None  # no more deliveries to a dead consumer
        acct = self._tenant(ticket.tenant)
        acct["cancelled"] = acct.get("cancelled", 0) + 1
        self.cancellations[reason] = self.cancellations.get(reason, 0) + 1
        self._inflight.pop(rid, None)
        self._tickets.pop(rid, None)  # caller holds the Ticket
        if TRACER.enabled:
            TRACER.instant(
                "router.cancel", cat="router", rid=rid, reason=reason,
            )
        return True

    def _cancel_stale(self) -> None:
        """Cancel in-flight work nobody can use anymore: abandoned tickets
        (the streaming consumer disconnected — before this existed they
        decoded to ``max_new`` on a lane nobody was reading) and running
        requests whose deadline expired after lane binding (deadlines were
        previously only enforced at submit and dispatch). Queued tickets
        with expired deadlines keep the established reject path in
        ``_dispatch``/``_purge_expired``."""
        now = time.monotonic()
        for ticket in list(self._inflight.values()):
            if ticket.abandoned:
                self.cancel(ticket.rid, reason="abandoned")
            elif (
                ticket.status == "running"
                and ticket.req is not None
                and ticket.req.deadline is not None
                and now > ticket.req.deadline
            ):
                self.cancel(ticket.rid, reason="deadline_expired")

    def _deliver(self) -> None:
        for ticket in list(self._inflight.values()):
            req = ticket.req
            if ticket.abandoned:
                # consumer is gone: feeding its queue would grow it
                # unbounded (the ticket itself is cancelled next pump)
                ticket.on_token = None
            if len(req.out) > ticket.sent:
                if ticket.on_token is not None:
                    for tok in req.out[ticket.sent :]:
                        ticket.on_token(tok)
                ticket.sent = len(req.out)
            if req.status == "numeric_error":
                # the engine's nonfinite guard retired it terminally; the
                # tokens generated BEFORE the poisoned step were delivered
                # above and stay valid (never the NaN-argmax token itself)
                ticket.status = "numeric_error"
                ticket.reason = req.cancel_reason or "nonfinite_logits"
                ticket.t_done = time.monotonic()
                acct = self._tenant(ticket.tenant)
                acct["numeric_error"] = acct.get("numeric_error", 0) + 1
                del self._inflight[ticket.rid]
                self._tickets.pop(ticket.rid, None)
            elif req.done:
                ticket.status = "done"
                ticket.t_done = time.monotonic()
                acct = self._tenant(ticket.tenant)
                acct["completed"] += 1
                acct["tokens"] += len(req.out)
                del self._inflight[ticket.rid]
                # drop our reference: a long-lived router must not retain
                # every finished request's tokens (the caller has the
                # Ticket; aggregates live in self.tenants / engine metrics)
                self._tickets.pop(ticket.rid, None)

    # -- replica health --------------------------------------------------
    @property
    def healthy_replicas(self) -> int:
        return sum(h["healthy"] for h in self._health)

    def _eject(self, i: int, reason: str) -> None:
        """Take replica ``i`` out of rotation and move its live requests
        (engine queue, bound lanes, preempted stash) back into the router
        queue for redispatch to the healthy pool. Resubmission preserves
        ``t_submit``/``t_first`` (latency stays honest) and relies on each
        ticket's ``sent`` cursor for idempotent delivery: greedy decode is
        deterministic, so a healthy replica regenerates the identical
        stream and already-delivered tokens are skipped."""
        h = self._health[i]
        h["healthy"] = False
        h["pumps_since_probe"] = 0
        self.ejections += 1
        if TRACER.enabled:
            TRACER.instant(
                "router.eject", cat="router", replica=i, reason=reason,
            )
        for req in self.engines[i].evacuate():
            ticket = self._tickets.get(req.rid)
            if ticket is None or ticket.status in (
                "done", "rejected", "cancelled", "numeric_error"
            ):
                continue
            self._queue.submit(req)  # t_submit preserved by the scheduler
            self._queued_by_tenant[req.tenant] = (
                self._queued_by_tenant.get(req.tenant, 0) + 1
            )
            ticket.status = "queued"
            self.resubmits += 1
            if TRACER.enabled:
                TRACER.instant(
                    "router.resubmit", cat="router", rid=req.rid,
                    replica=i, delivered=ticket.sent,
                )

    def _on_step_failure(self, i: int, exc: Exception) -> None:
        h = self._health[i]
        h["last_error"] = f"{type(exc).__name__}: {exc}"
        if isinstance(exc, ReplicaCrash):
            self._eject(i, reason="crash")
            return
        h["consecutive_failures"] += 1
        if h["consecutive_failures"] >= self.eject_after:
            self._eject(i, reason="consecutive_failures")

    def _maybe_probe(self, i: int) -> None:
        """Every ``probe_every`` pumps, try one (empty) step on an ejected
        replica; a clean return reinstates it. A crashed replica keeps
        raising and stays out of rotation."""
        h = self._health[i]
        h["pumps_since_probe"] += 1
        if h["pumps_since_probe"] < self.probe_every:
            return
        h["pumps_since_probe"] = 0
        try:
            self.engines[i].step_once()  # evacuated: probes the step path
        except Exception as exc:  # noqa: BLE001 - any failure keeps it out
            h["last_error"] = f"{type(exc).__name__}: {exc}"
            return
        h["healthy"] = True
        h["consecutive_failures"] = 0
        h["last_error"] = None
        self.reinstatements += 1
        if TRACER.enabled:
            TRACER.instant("router.reinstate", cat="router", replica=i)

    def pump(self) -> bool:
        """One scheduling round: dispatch queued work, advance every busy
        healthy replica one batched step, deliver new tokens, probe
        ejected replicas. Returns True while there is anything left to
        do."""
        with TRACER.span("router.pump", cat="router"):
            self._cancel_stale()
            if not any(h["healthy"] for h in self._health) and self._queue:
                # total outage: the breaker is open — bounce the backlog
                # with the distinct reason instead of holding requests
                # (and drain() loops) hostage to a probe that may never
                # succeed. New submissions are already rejected at intake.
                while self._queue:
                    req = self._queue.pop()
                    self._queued_by_tenant[req.tenant] -= 1
                    self._reject(self._tickets[req.rid],
                                 "no_healthy_replicas")
            self._dispatch()
            progressed = False
            for i, e in enumerate(self.engines):
                if not self._health[i]["healthy"]:
                    self._maybe_probe(i)
                    progressed = progressed or self._health[i]["healthy"]
                    continue
                if e.has_work():
                    try:
                        progressed = e.step_once() or progressed
                        self._health[i]["consecutive_failures"] = 0
                    except Exception as exc:  # noqa: BLE001 - health layer
                        # A replica failure must never take the router
                        # down: record it, maybe eject, and let the
                        # resubmitted work land on the healthy pool.
                        self._on_step_failure(i, exc)
                        progressed = True  # health state advanced
            self._deliver()
            if TRACER.enabled:
                # predicted-cost counter tracks (cost.<op>) beside the pump
                # spans: the kernels' modelled FLOPs and bytes against time
                kernel_dispatch.LEDGER.emit_counters(TRACER)
        return progressed or bool(self._queue) or bool(self._inflight)

    def drain(self) -> None:
        """Run to completion (the synchronous batch entry point)."""
        while self.pump():
            pass
        for e in self.engines:
            e.metrics.stop()

    # -- reporting -------------------------------------------------------
    def note_retry(self) -> None:
        """Count one admission retry made by an upstream layer (the HTTP
        server's backoff loop): ``repro_retries_total``."""
        self.retries += 1

    @property
    def idle(self) -> bool:
        """True when nothing is queued or in flight — the drain condition
        the HTTP layer's /admin/drain waits on."""
        return not self._queue and not self._inflight

    @property
    def prefix_cache(self):
        """The prefix cache shared by every replica (or None). All
        replicas are built over one cache, so the first engine's is THE
        cache."""
        return self.engines[0].prefix_cache

    def stats(self) -> dict:
        """Cheap liveness snapshot (no percentile math, no record scans)
        for health endpoints: replica/lane capacity, backlog, in-flight
        count, and rejection counters."""
        return {
            "replicas": len(self.engines),
            "healthy_replicas": self.healthy_replicas,
            "lanes": sum(e.lanes_n for e in self.engines),
            "free_lanes": sum(e.free_lanes for e in self.engines),
            "queued": len(self._queue),
            "inflight": len(self._inflight),
            "tenants": len(self.tenants),
            "rejections": dict(self.rejections),
            "cancellations": dict(self.cancellations),
            "ejections": self.ejections,
            "reinstatements": self.reinstatements,
            "resubmits": self.resubmits,
            "retries": self.retries,
            "replica_health": [
                {
                    "replica": i,
                    "healthy": h["healthy"],
                    "consecutive_failures": h["consecutive_failures"],
                    "last_error": h["last_error"],
                }
                for i, h in enumerate(self._health)
            ],
            "faults": FAULTS.stats(),
        }

    def report(self) -> dict:
        """Aggregate across replicas + router-level accounting."""
        reps = [e.metrics.report() for e in self.engines]
        records = [r for e in self.engines for r in e.metrics.records]
        summed = {
            k: sum(r[k] for r in reps)
            for k in (
                "requests", "steps", "prefill_steps", "decode_steps",
                "emitted_tokens", "prompt_tokens", "cache_lookups",
                "cache_hits", "cache_full_hits", "prefill_tokens_saved",
                "cancelled", "preemptions", "resumes", "numeric_errors",
            )
        }
        summed["cancellations"] = dict(self.cancellations)
        summed["ejections"] = self.ejections
        summed["reinstatements"] = self.reinstatements
        summed["resubmits"] = self.resubmits
        summed["retries"] = self.retries
        summed["healthy_replicas"] = self.healthy_replicas
        summed["faults_injected"] = dict(FAULTS.injected)
        summed["cache_hit_rate"] = (
            summed["cache_hits"] / summed["cache_lookups"]
            if summed["cache_lookups"]
            else 0.0
        )
        ttfts = np.array([r.ttft for r in records])
        summed["ttft_mean_s"] = float(ttfts.mean()) if ttfts.size else 0.0
        summed["ttft_p95_s"] = (
            float(np.percentile(ttfts, 95)) if ttfts.size else 0.0
        )
        summed["replicas"] = len(self.engines)
        summed["queued"] = len(self._queue)
        summed["rejections"] = dict(self.rejections)
        percentiles = tenant_summary(records)  # one pass groups all tenants
        summed["tenants"] = {
            t: {**acct, **percentiles.get(t, {})}
            for t, acct in sorted(self.tenants.items())
        }
        summed["phases"] = phase_summary(records)
        # cumulative histograms sum elementwise across replicas (identical
        # bucket bounds), staying monotonic
        summed["ttft_hist_ms"] = LatencyHistogram.merge_reports(
            r.get("ttft_hist_ms") for r in reps
        )
        summed["tpot_hist_ms"] = LatencyHistogram.merge_reports(
            r.get("tpot_hist_ms") for r in reps
        )
        return summed

    def scrape(self) -> dict:
        """Everything a /metrics scrape reads, in one call: the aggregate
        report, the liveness stats, the shared prefix cache's stats and the
        kernel cost ledger's rows. Like ``report``/``stats`` it iterates
        collections a pump mutates, so the HTTP layer calls it through
        ``AsyncRouter.snapshot`` (the pump lock); one entry point keeps
        every scrape consumer behind that lock."""
        cache = self.prefix_cache
        return {
            "report": self.report(),
            "stats": self.stats(),
            "cache": cache.stats() if cache is not None else None,
            # the process-wide dispatch ledger: the kernels this router's replicas ran
            "cost": kernel_dispatch.LEDGER.rows(),
        }


class AsyncRouter:
    """asyncio facade: concurrent coroutines share one pump (serialized by
    a lock, executed off-loop in a worker thread so the event loop stays
    responsive while the device steps).

    The Router itself is NOT thread-safe; every mutation — submissions
    included — must happen under ``self._lock`` so a submit on the event
    loop can never interleave with a pump running in the worker thread
    (heapq operations are multi-step and would corrupt the queue)."""

    def __init__(self, router: Router):
        self.router = router
        self._lock = asyncio.Lock()

    async def _pump_once(self) -> None:
        """One pump in a worker thread. Caller MUST hold ``self._lock``."""
        fut = asyncio.ensure_future(asyncio.to_thread(self.router.pump))
        try:
            await asyncio.shield(fut)
        except asyncio.CancelledError:
            # cancelled (e.g. the caller cancelled generate()): the pump
            # thread is still mutating the router — wait for it before the
            # lock is released, THEN propagate
            await fut
            raise

    async def _drive(self, ticket: Ticket) -> Ticket:
        # NOT cancelled from outside: a cancel while the pump thread runs
        # would release the lock mid-pump and let a concurrent submit race
        # it. Early consumers set ticket.abandoned instead, bounding the
        # wait at one pump (one batched engine step), after which the loop
        # exits between pumps.
        terminal = ("done", "rejected", "cancelled", "numeric_error")
        while ticket.status not in terminal and not ticket.abandoned:
            async with self._lock:
                if ticket.status in terminal or ticket.abandoned:
                    break
                await self._pump_once()
        return ticket

    async def join(self) -> None:
        """Pump until the router is fully idle (nothing queued, nothing in
        flight). The drain primitive: /admin/drain stops admission at the
        HTTP layer, then ``join()`` finishes every admitted request —
        including tickets whose streaming consumer disconnected and
        abandoned them."""
        while not self.router.idle:
            async with self._lock:
                if self.router.idle:
                    break
                await self._pump_once()

    async def generate(self, prompt, **kw) -> Ticket:
        """Submit and await completion; returns the finished Ticket (check
        ``ticket.ok`` / ``ticket.reason`` for rejection)."""
        async with self._lock:
            ticket = self.router.submit(prompt, **kw)
        if ticket.status == "rejected":
            return ticket
        return await self._drive(ticket)

    async def open_stream(self, prompt, **kw):
        """Submit for streaming; returns ``(ticket, token_iterator)``.

        On rejection the iterator is ``None`` and the ticket carries the
        reason — no exception, so protocol frontends can map the reason to
        a wire-level status *before* committing to a streaming response.
        The iterator (when present) yields tokens as they are produced and
        must be fully consumed or ``aclose()``d.
        """
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()
        done = object()  # completion sentinel: no polling, no tail latency
        async with self._lock:
            ticket = self.router.submit(
                prompt,
                on_token=lambda tok: loop.call_soon_threadsafe(q.put_nowait, tok),
                **kw,
            )
        if ticket.status == "rejected":
            return ticket, None

        async def tokens():
            async def drive():
                try:
                    await self._drive(ticket)
                finally:
                    # runs on the event loop AFTER any pending token
                    # callbacks scheduled from the pump thread (loop
                    # callbacks are FIFO)
                    q.put_nowait(done)

            task = asyncio.create_task(drive())
            try:
                while (tok := await q.get()) is not done:
                    yield tok
            finally:
                ticket.abandoned = True
                await task

        return ticket, tokens()

    async def cancel(self, rid: int, reason: str = "client_cancel") -> bool:
        """Cancel an in-flight request by rid (the DELETE endpoint), under
        the pump lock: the lane is released between two batched steps."""
        async with self._lock:
            return self.router.cancel(rid, reason=reason)

    async def snapshot(self, fn):
        """``fn(router)`` under the pump lock, and its result: the safe way to
        read aggregate state (``report``, ``stats``, ``scrape``) while pumps
        run in a worker thread. Keep ``fn`` host-side and cheap; it delays
        the next pump."""
        async with self._lock:
            return fn(self.router)

    async def stream(self, prompt, **kw):
        """Async generator of tokens as they are produced. Raises
        ``RequestRejected`` (carrying the ticket) on admission rejection.

        If the consumer exits early (break / connection drop), the ticket
        is marked abandoned: this coroutine stops driving it within one
        pump, and the next pump from any source cancels it inside the
        engine (``_cancel_stale`` → ``ServeEngine.cancel``), freeing its
        lane instead of decoding to ``max_new`` for nobody.
        """
        ticket, toks = await self.open_stream(prompt, **kw)
        if toks is None:
            raise RequestRejected(ticket)
        try:
            async for tok in toks:
                yield tok
        finally:
            # `async for` does not close a half-consumed inner generator on
            # early exit; closing it here is what flips ticket.abandoned
            await toks.aclose()
