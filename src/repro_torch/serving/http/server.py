"""HTTP/SSE network service over the frontend ``AsyncRouter``.

Counterpart of ``repro.serving.http.server``: the network boundary over the
whole serving stack (packed FloatSD8 codes -> the CUDA kernels -> the
batching engine -> the FP8 prefix cache -> the router -> this server).
Stdlib only (``asyncio.start_server`` + the protocol module in this
package).

Endpoints:

* ``POST /v1/generate``: JSON in/out, blocks until the request retires.
* ``POST /v1/stream``: Server-Sent Events: a ``start`` event carrying the
  request id (so a client can cancel mid-stream), one frame per token,
  then a terminal ``done`` event. Disconnecting mid-stream cancels the
  request inside the engine within one pump: the lane is freed, not
  decoded to ``max_new``.
* ``DELETE /v1/requests/{rid}``: cancellation of an in-flight request by
  id (200 with ``{"cancelled": true}``, or 404 if the rid is unknown or
  already finished).
* ``GET  /healthz``: liveness and capacity snapshot (``Router.stats()``).
* ``GET  /metrics``: Prometheus text exposition (engine counters,
  prefix-cache counters, per-tenant percentiles, the dispatch counts and
  the kernel cost ledger).
* ``POST /admin/drain``: graceful shutdown: stops admission (new
  submissions get 503 ``draining``), finishes every in-flight request
  through ``AsyncRouter.join()``, then ends ``serve_forever``.
* ``GET  /admin/trace``: the request-lifecycle tracer's ring buffer as
  Chrome trace-event JSON (Perfetto, chrome://tracing). The server turns
  the process tracer on at ``start()`` unless built with ``trace=False``.

Request conventions: the tenant comes from the ``X-Tenant`` header
(default ``"default"``); the deadline from the JSON field ``deadline_ms``
(a relative budget, converted to the router's absolute monotonic
deadline at parse time); a boolean JSON field ``debug`` asks for the
per-request phase breakdown (``queue_ms``/``prefill_ms``/``decode_ms``/
``cache_saved_steps``...) in the ``/v1/generate`` response and the terminal
SSE ``done`` event. Router reject reasons map to distinct HTTP status
codes: see ``REASON_STATUS``. A request whose device step fails is never
answered 200: the router ejects the failing replica and resubmits its
requests, and once every replica is out it rejects them as
``no_healthy_replicas`` (503).

Concurrency contract: one asyncio task per connection; every router
mutation goes through the ``AsyncRouter`` lock, and device steps run in a
worker thread (``asyncio.to_thread``) so the event loop keeps accepting
connections while the engine computes (a kernel launches on the worker
thread's current CUDA stream). The server object itself must be used from
a single event loop.

Shutdown order: ``serve_forever`` stops listening, ends the connection
tasks (idle keep-alive readers are cancelled after a grace period), and
only then awaits ``Server.wait_closed()``, which since Python 3.12.1 waits
for every connection to drop: the other order never returns while a
client keeps its connection open.
"""
from __future__ import annotations

import asyncio
import time
import traceback
from typing import Optional

from ...faults import FAULTS, SOCKET_DROP
from ...kernels import dispatch as kernel_dispatch
from ...obs.trace import TRACER
from ..frontend.router import AsyncRouter, Router, Ticket
from .protocol import (
    HttpRequest,
    ProtocolError,
    json_response,
    read_request,
    render_response,
    sse_event,
    sse_preamble,
)
from .prometheus import CONTENT_TYPE as PROM_CONTENT_TYPE
from .prometheus import render_metrics

__all__ = ["HttpServer", "REASON_STATUS"]

# Distinct status per reject reason (the acceptance bar). Note one
# deliberate choice: queue_full is the *server-wide* overload signal, so
# it maps to 503 + Retry-After (the standard load-shed answer), while 429
# is reserved for the caller-specific tenant_quota — this keeps all four
# reasons distinguishable by status code alone, not just by body.
REASON_STATUS = {
    "bad_request": 400,
    "tenant_quota": 429,
    "queue_full": 503,
    "deadline_expired": 504,
    # the router's circuit breaker: every replica ejected. 503 like
    # queue_full (the condition is transient — probes reinstate), but the
    # distinct body reason tells operators it is health, not load.
    "no_healthy_replicas": 503,
}
_RETRYABLE = (429, 503)


def _reject_response(reason: str, keep_alive: bool = True) -> bytes:
    status = REASON_STATUS.get(reason, 500)
    extra = [("Retry-After", "1")] if status in _RETRYABLE else []
    return json_response(
        status,
        {"error": reason},
        extra_headers=extra,
        keep_alive=keep_alive,
    )


class HttpServer:
    def __init__(
        self,
        router: Router,
        host: str = "127.0.0.1",
        port: int = 0,
        default_max_new: int = 32,
        max_new_cap: int = 1024,
        trace: bool = True,
        admit_retries: int = 2,
        retry_backoff_s: float = 0.05,
    ):
        self.router = router
        self.aroute = AsyncRouter(router)
        self.host = host
        self.port = port  # replaced by the bound port after start()
        self.default_max_new = default_max_new
        self.max_new_cap = max_new_cap
        # transient-rejection absorption: a "queue_full" bounce while at
        # least one replica is healthy is retried in-server with backoff
        # (admit_retries extra attempts) before the 503 reaches the wire —
        # the common cause is an ejection burst resubmitting a replica's
        # live requests into the router queue, which clears within pumps.
        self.admit_retries = admit_retries
        self.retry_backoff_s = retry_backoff_s
        self.trace = trace  # enable the process tracer on start()
        self.draining = False
        self.t_start: Optional[float] = None
        self._server: Optional[asyncio.base_events.Server] = None
        self._shutdown = asyncio.Event()
        self._conns: set = set()
        self._drain_task: Optional[asyncio.Task] = None
        self._admitting = 0  # handlers between their draining-check and submit
        self.http_requests = 0  # HTTP-level request counter (all endpoints)

    # -- lifecycle -------------------------------------------------------
    async def start(self) -> "HttpServer":
        if self.trace:
            # the process-wide tracer (obs.trace.TRACER): /admin/trace
            # serves its ring buffer; the bounded ring makes always-on safe
            TRACER.enable()
        self._server = await asyncio.start_server(
            self._on_connection, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        self.t_start = time.monotonic()
        return self

    @property
    def uptime_s(self) -> float:
        return time.monotonic() - self.t_start if self.t_start else 0.0

    async def serve_forever(self) -> None:
        """Serve until /admin/drain completes (or ``shutdown()``)."""
        if self._server is None:
            await self.start()
        await self._shutdown.wait()
        self._server.close()  # stop listening
        if self._conns:
            # in-flight work already drained (join); give response writers
            # a moment, then cancel idle keep-alive readers
            _done, pending = await asyncio.wait(set(self._conns), timeout=2.0)
            for t in pending:
                t.cancel()
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)
        # after the connections: wait_closed waits for every one to drop
        await self._server.wait_closed()
        for e in self.router.engines:
            e.metrics.stop()

    def shutdown(self) -> None:
        self._shutdown.set()

    async def _do_drain(self) -> None:
        # A handler increments _admitting BEFORE checking self.draining
        # (both in one event-loop step, so the orderings can't interleave):
        # any handler that saw draining=False is therefore visible here,
        # and we keep joining until its submission has landed and drained
        # — closing the check-then-submit race where join() could observe
        # an idle router a moment before the late request entered it.
        try:
            while True:
                await self.aroute.join()
                if self._admitting == 0 and self.router.idle:
                    break
                await asyncio.sleep(0.01)
        except BaseException:
            # an engine failure mid-drain must not leave the server hung
            # with admission stopped and _shutdown never set — surface the
            # root cause (nothing awaits this background task) and exit
            traceback.print_exc()
            raise
        finally:
            self.shutdown()

    # -- connection plumbing ---------------------------------------------
    async def _on_connection(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            await self._connection_loop(reader, writer)
        except (
            ConnectionError,
            asyncio.IncompleteReadError,
            asyncio.CancelledError,
        ):
            pass  # client went away / shutdown: nothing to answer
        finally:
            self._conns.discard(task)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _connection_loop(self, reader, writer) -> None:
        while True:
            try:
                req = await read_request(reader)
            except ProtocolError as e:
                writer.write(
                    json_response(
                        e.status, {"error": "protocol", "detail": e.detail},
                        keep_alive=False,
                    )
                )
                await writer.drain()
                return
            if req is None:
                return
            self.http_requests += 1
            # async scope on the shared event-loop thread: stamped as one
            # retroactive X event at completion (see Tracer.complete)
            t0_us = time.monotonic_ns() // 1000 if TRACER.enabled else 0
            try:
                close = await self._route(req, writer)
            except ProtocolError as e:
                writer.write(
                    json_response(
                        e.status, {"error": "protocol", "detail": e.detail}
                    )
                )
                close = False
            except (ConnectionError, asyncio.CancelledError):
                raise
            except Exception as e:  # handler bug: answer, then drop the conn
                writer.write(
                    json_response(
                        500,
                        {"error": "internal", "detail": f"{type(e).__name__}: {e}"},
                        keep_alive=False,
                    )
                )
                close = True
            await writer.drain()
            if TRACER.enabled:
                now_us = time.monotonic_ns() // 1000
                TRACER.complete(
                    "http.request", t0_us, now_us - t0_us, cat="http",
                    method=req.method, path=req.path,
                )
            if close or not req.keep_alive:
                return

    async def _route(self, req: HttpRequest, writer) -> bool:
        """Dispatch one request. Returns True when the connection must
        close (SSE streams, handler failures)."""
        route = (req.method, req.path)
        if route == ("POST", "/v1/generate"):
            writer.write(await self._generate(req))
            return False
        if route == ("POST", "/v1/stream"):
            return await self._stream(req, writer)
        if route == ("GET", "/healthz"):
            writer.write(await self._healthz())
            return False
        if route == ("GET", "/metrics"):
            writer.write(await self._metrics())
            return False
        if route == ("POST", "/admin/drain"):
            writer.write(await self._drain())
            return False
        if route == ("GET", "/admin/trace"):
            writer.write(self._trace())
            return False
        if req.path.startswith("/v1/requests/"):
            if req.method != "DELETE":
                writer.write(
                    json_response(
                        405, {"error": "method_not_allowed", "path": req.path}
                    )
                )
                return False
            writer.write(await self._cancel(req))
            return False
        known = {"/v1/generate", "/v1/stream", "/healthz", "/metrics",
                 "/admin/drain", "/admin/trace"}
        if req.path in known:
            writer.write(
                json_response(405, {"error": "method_not_allowed", "path": req.path})
            )
        else:
            writer.write(json_response(404, {"error": "not_found", "path": req.path}))
        return False

    # -- request parsing -------------------------------------------------
    def _parse_submission(self, req: HttpRequest) -> tuple[dict, bool]:
        """Returns (router submit kwargs, debug flag)."""
        body = req.json()
        if "prompt" not in body:
            raise ProtocolError(400, "missing required field 'prompt'")
        debug = body.get("debug", False)
        if not isinstance(debug, bool):
            raise ProtocolError(400, "'debug' must be a boolean")
        max_new = body.get("max_new", self.default_max_new)
        if not isinstance(max_new, int) or isinstance(max_new, bool):
            raise ProtocolError(400, "'max_new' must be an integer")
        if max_new > self.max_new_cap:
            raise ProtocolError(
                400, f"'max_new' exceeds the server cap of {self.max_new_cap}"
            )
        deadline = None
        if body.get("deadline_ms") is not None:
            d = body["deadline_ms"]
            if not isinstance(d, (int, float)) or isinstance(d, bool):
                raise ProtocolError(400, "'deadline_ms' must be a number")
            # relative budget on the wire -> absolute monotonic deadline
            deadline = time.monotonic() + float(d) / 1e3
        return (
            dict(
                prompt=body["prompt"],
                max_new=max_new,
                tenant=req.headers.get("x-tenant", "default"),
                deadline=deadline,
            ),
            debug,
        )

    def _retryable(self, ticket: Ticket) -> bool:
        """A rejection worth retrying in-server: transient backpressure
        ("queue_full" — e.g. an ejection burst just resubmitted a dead
        replica's requests into the router queue) while at least one
        healthy replica remains to clear it. Health/breaker rejections
        ("no_healthy_replicas") and caller errors go straight to the wire.
        Reads ``healthy_replicas`` without the pump lock: a stale-by-one-
        pump read only costs one extra (harmless) retry."""
        return (
            not ticket.ok
            and ticket.reason == "queue_full"
            and self.router.healthy_replicas > 0
            and not self.draining
        )

    async def _backoff(self, attempt: int) -> None:
        await self.aroute.snapshot(lambda r: r.note_retry())
        await asyncio.sleep(self.retry_backoff_s * (2 ** attempt))

    # -- endpoint handlers -----------------------------------------------
    async def _cancel(self, req: HttpRequest) -> bytes:
        """DELETE /v1/requests/{rid}: explicit engine-level cancellation.
        The rid comes from the generate/stream response (``rid`` field /
        the SSE ``start`` event)."""
        suffix = req.path[len("/v1/requests/"):]
        try:
            rid = int(suffix)
        except ValueError:
            raise ProtocolError(400, f"request id must be an integer, got {suffix!r}")
        cancelled = await self.aroute.cancel(rid)
        if not cancelled:
            # unknown, finished, or already cancelled: nothing to release
            return json_response(404, {"error": "unknown_request", "rid": rid})
        return json_response(200, {"rid": rid, "cancelled": True})

    async def _generate(self, req: HttpRequest) -> bytes:
        self._admitting += 1  # before the draining check: see _do_drain
        try:
            if self.draining:
                return json_response(
                    503, {"error": "draining"},
                    extra_headers=[("Retry-After", "5")],
                )
            kw, debug = self._parse_submission(req)
            for attempt in range(self.admit_retries + 1):
                ticket = await self.aroute.generate(**kw)
                if attempt >= self.admit_retries or not self._retryable(ticket):
                    break
                await self._backoff(attempt)
        finally:
            self._admitting -= 1
        if not ticket.ok:
            return _reject_response(ticket.reason)
        r = ticket.req
        if ticket.status == "cancelled" and ticket.reason == "deadline_expired":
            # the deadline expired after lane binding: same contract as a
            # queue-time expiry — the client asked for a budget we missed
            return _reject_response("deadline_expired")
        payload = {
            "rid": ticket.rid,
            "tenant": ticket.tenant,
            "tokens": ticket.tokens,
            "n_tokens": len(ticket.tokens),
            # a request cancelled before its first token has no TTFT
            "ttft_ms": (
                (r.t_first - r.t_submit) * 1e3 if r.t_first is not None else None
            ),
            "latency_ms": (ticket.t_done - r.t_submit) * 1e3,
        }
        if ticket.status == "cancelled":
            # explicit cancel mid-generate: 200 with the partial tokens —
            # the caller (or another connection) asked for this outcome
            payload["status"] = "cancelled"
            payload["reason"] = ticket.reason
        elif ticket.status == "numeric_error":
            # the engine's nonfinite-logit guard retired the request: the
            # partial tokens are valid (generated before the poisoned
            # step), the status tells the caller the tail is missing
            payload["status"] = "numeric_error"
            payload["reason"] = ticket.reason
        if debug:
            payload["phases"] = r.phases()
        return json_response(200, payload)

    async def _stream(self, req: HttpRequest, writer) -> bool:
        self._admitting += 1  # before the draining check: see _do_drain
        try:
            if self.draining:
                writer.write(
                    json_response(
                        503, {"error": "draining"},
                        extra_headers=[("Retry-After", "5")],
                    )
                )
                return False
            kw, debug = self._parse_submission(req)
            # submit BEFORE committing to a status line: a rejection must
            # reach the client as its mapped status, not a broken stream
            for attempt in range(self.admit_retries + 1):
                ticket, toks = await self.aroute.open_stream(**kw)
                if attempt >= self.admit_retries or not self._retryable(ticket):
                    break
                await self._backoff(attempt)
        finally:
            self._admitting -= 1
        if toks is None:
            writer.write(_reject_response(ticket.reason))
            return False
        writer.write(sse_preamble())
        # rid first: a streaming client can only DELETE /v1/requests/{rid}
        # mid-stream if it learns the rid before the tokens start
        writer.write(
            sse_event({"rid": ticket.rid, "tenant": ticket.tenant}, event="start")
        )
        await writer.drain()
        index = 0
        try:
            async for tok in toks:
                if FAULTS.enabled and FAULTS.fire(
                    SOCKET_DROP, key=ticket.rid, rid=ticket.rid
                ) is not None:
                    # abort the connection mid-stream: the finally below
                    # closes the token iterator, which abandons the ticket
                    # — the engine cancels it within one pump instead of
                    # decoding to max_new for a dead socket
                    raise ConnectionError("injected socket drop")
                writer.write(sse_event({"index": index, "token": int(tok)}))
                await writer.drain()
                index += 1
            if not ticket.ok:
                # rejected AFTER admission (deadline expired in the queue):
                # the 200 preamble is already on the wire, so the mapped
                # status travels as a terminal error event instead
                writer.write(
                    sse_event(
                        {
                            "error": ticket.reason,
                            "status": REASON_STATUS.get(ticket.reason, 500),
                        },
                        event="error",
                    )
                )
                await writer.drain()
                return True
            if ticket.status == "cancelled" and ticket.reason == "deadline_expired":
                # mid-flight deadline: surface the same 504 contract the
                # queue-time expiry uses, as a terminal error event
                writer.write(
                    sse_event(
                        {
                            "error": "deadline_expired",
                            "status": REASON_STATUS["deadline_expired"],
                            "n_tokens": len(ticket.tokens),
                        },
                        event="error",
                    )
                )
                await writer.drain()
                return True
            r = ticket.req
            done_payload = {
                "rid": ticket.rid,
                "tenant": ticket.tenant,
                "n_tokens": len(ticket.tokens),
                "ttft_ms": (
                    (r.t_first - r.t_submit) * 1e3 if r.t_first is not None else None
                ),
                "latency_ms": (ticket.t_done - r.t_submit) * 1e3,
            }
            if ticket.status == "cancelled":
                # explicit DELETE while streaming: terminal done frame with
                # the partial count — the consumer asked for this outcome
                done_payload["status"] = "cancelled"
                done_payload["reason"] = ticket.reason
            elif ticket.status == "numeric_error":
                # nonfinite-logit retire mid-stream: the tokens already on
                # the wire are valid; the terminal frame flags the cut
                done_payload["status"] = "numeric_error"
                done_payload["reason"] = ticket.reason
            if debug:
                done_payload["phases"] = r.phases()
            writer.write(sse_event(done_payload, event="done"))
            await writer.drain()
            if TRACER.enabled:
                TRACER.instant(
                    "http.sse_flush", cat="http", rid=ticket.rid,
                    frames=index + 1,
                )
        finally:
            # closing a half-consumed iterator abandons the ticket, so a
            # dropped connection stops burning device steps within one pump
            await toks.aclose()
        return True  # SSE streams are delimited by connection close

    # Aggregate reads go through AsyncRouter.snapshot (the pump lock):
    # report()/stats() iterate collections a worker-thread pump mutates.
    async def _healthz(self) -> bytes:
        stats = await self.aroute.snapshot(lambda r: r.stats())
        return json_response(
            200 if not self.draining else 503,
            {
                "status": "draining" if self.draining else "ok",
                "uptime_s": self.uptime_s,
                **stats,
            },
        )

    async def _metrics(self) -> bytes:
        # One consolidated scrape read under the pump lock: Router.scrape()
        # bundles report + stats + prefix-cache stats so no consumer can
        # re-assemble the pieces and miss the lock on one of them. Dispatch
        # and tracer stats are internally locked and safe to read here.
        scrape = await self.aroute.snapshot(lambda r: r.scrape())
        text = render_metrics(
            scrape["report"],
            scrape["stats"],
            cache_stats=scrape["cache"],
            draining=self.draining,
            uptime_s=self.uptime_s,
            http_requests=self.http_requests,
            dispatch_counts=kernel_dispatch.STATS.snapshot(),
            trace_stats=TRACER.stats(),
            cost_rows=scrape["cost"],
        )
        return render_response(
            200, text.encode("utf-8"), content_type=PROM_CONTENT_TYPE
        )

    def _trace(self) -> bytes:
        """GET /admin/trace: the tracer ring as Chrome trace-event JSON.
        The tracer snapshots under its own lock, so this does not need the
        pump lock (and must not hold it: the export can be MBs)."""
        return json_response(200, TRACER.chrome_trace())

    async def _drain(self) -> bytes:
        stats = await self.aroute.snapshot(lambda r: r.stats())
        if not self.draining:  # idempotent: repeat calls report progress
            self.draining = True
            self._drain_task = asyncio.get_running_loop().create_task(
                self._do_drain()
            )
        return json_response(
            200,
            {
                "status": "draining",
                "queued": stats["queued"],
                "inflight": stats["inflight"],
            },
        )
