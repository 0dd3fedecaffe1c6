"""Minimal asyncio HTTP/SSE client for the serving API.

Counterpart of ``repro.serving.http.client`` (stdlib only; the port keeps
its own copy). The tests and ``chip_smoke.py`` speak to ``server.py``
through it, so the wire format is exercised by one implementation on each
side.

``Client`` keeps one keep-alive connection for JSON endpoints and opens a
dedicated connection per SSE stream (the server delimits event streams by
connection close). Non-2xx responses raise ``HttpError`` carrying the
status and decoded body, so callers can assert on the reject mapping.

Failure semantics (every await is bounded: a dead server can never hang
a caller forever):

  * connects are retried up to ``connect_retries`` times with jittered
    exponential backoff before raising;
  * every response read is capped at ``timeout_s`` and raises
    ``asyncio.TimeoutError`` (the connection is torn down: a late
    response must not be misread as the answer to the *next* request);
  * a failed round trip is re-sent only when a REUSED pooled connection
    broke (stale keep-alive socket), never after a fresh-connection
    failure or a timeout: the server may already be executing the
    request, and blind re-sends would double the device work.
"""
from __future__ import annotations

import asyncio
import json
import random
from typing import Any, AsyncIterator, Optional, Tuple

__all__ = ["Client", "HttpError"]


class HttpError(Exception):
    def __init__(self, status: int, body: Any):
        reason = body.get("error") if isinstance(body, dict) else None
        super().__init__(f"HTTP {status}: {reason or body}")
        self.status = status
        self.body = body
        self.reason = reason


def _request_bytes(
    method: str,
    path: str,
    host: str,
    body: Optional[bytes],
    headers: Optional[dict],
) -> bytes:
    lines = [f"{method} {path} HTTP/1.1", f"Host: {host}"]
    if body is not None:
        lines.append("Content-Type: application/json")
        lines.append(f"Content-Length: {len(body)}")
    for k, v in (headers or {}).items():
        lines.append(f"{k}: {v}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + (body or b"")


async def _read_response_head(reader) -> Tuple[int, dict]:
    status_line = await reader.readuntil(b"\r\n")
    parts = status_line.decode("latin-1").split(None, 2)
    if len(parts) < 2 or not parts[0].startswith("HTTP/1."):
        raise ConnectionError(f"malformed status line: {status_line!r}")
    status = int(parts[1])
    headers: dict = {}
    while True:
        line = await reader.readuntil(b"\r\n")
        if line == b"\r\n":
            break
        name, _, value = line.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    return status, headers


class Client:
    def __init__(
        self,
        host: str,
        port: int,
        tenant: Optional[str] = None,
        timeout_s: float = 30.0,
        connect_retries: int = 2,
        backoff_s: float = 0.05,
    ):
        self.host = host
        self.port = port
        self.tenant = tenant
        self.timeout_s = timeout_s
        self.connect_retries = connect_retries
        self.backoff_s = backoff_s
        self.retries = 0  # connect + stale-socket retries performed
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None

    # -- connection management ------------------------------------------
    async def _connect(self) -> Tuple[asyncio.StreamReader, asyncio.StreamWriter]:
        """Connect with bounded jittered-backoff retry: a server that is
        mid-restart (or a listen backlog burst) answers on the second
        attempt instead of failing the whole call."""
        for attempt in range(self.connect_retries + 1):
            try:
                return await asyncio.wait_for(
                    asyncio.open_connection(self.host, self.port),
                    self.timeout_s,
                )
            except (OSError, asyncio.TimeoutError):
                if attempt >= self.connect_retries:
                    raise
                self.retries += 1
                await asyncio.sleep(
                    self.backoff_s * (2 ** attempt) * (1 + random.random())
                )
        raise ConnectionError("unreachable")  # loop always returns/raises

    async def _keepalive(
        self,
    ) -> Tuple[asyncio.StreamReader, asyncio.StreamWriter, bool]:
        """Returns (reader, writer, reused): ``reused`` is True when an
        existing pooled connection was handed out — the only case a
        failed round trip may be retried (see ``request``)."""
        if self._writer is None or self._writer.is_closing():
            self._reader, self._writer = await self._connect()
            return self._reader, self._writer, False
        return self._reader, self._writer, True

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass
            self._reader = self._writer = None

    async def __aenter__(self) -> "Client":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    def _headers(self, tenant: Optional[str]) -> dict:
        t = tenant if tenant is not None else self.tenant
        return {"X-Tenant": t} if t is not None else {}

    # -- plain JSON round trips -----------------------------------------
    async def request(
        self,
        method: str,
        path: str,
        body: Optional[dict] = None,
        headers: Optional[dict] = None,
    ) -> Tuple[int, dict, bytes]:
        """One keep-alive round trip: (status, headers, raw body bytes).

        Retried exactly once, and only when a REUSED pooled connection
        failed — the server closing an idle keep-alive socket between
        requests is indistinguishable from a send into a dead pipe, so
        the request is re-sent (after a jittered backoff) on a fresh
        connection. A failure on a fresh connection is never retried: for
        non-idempotent POSTs the first attempt may have executed
        server-side, and blind re-sends would double the device work.

        Every read is capped at ``timeout_s``: a server that accepted the
        request and then died mid-response raises ``asyncio.TimeoutError``
        here instead of hanging the caller forever. Timeouts are never
        retried (the request may be executing); the connection is closed
        so a late response cannot corrupt the next round trip.
        """
        payload = None if body is None else json.dumps(body).encode("utf-8")
        raw = _request_bytes(method, path, self.host, payload, headers)
        while True:
            reader, writer, reused = await self._keepalive()
            try:
                writer.write(raw)
                await writer.drain()
                status, hdrs = await asyncio.wait_for(
                    _read_response_head(reader), self.timeout_s
                )
                n = int(hdrs.get("content-length", 0))
                data = (
                    await asyncio.wait_for(reader.readexactly(n), self.timeout_s)
                    if n
                    else b""
                )
            except asyncio.TimeoutError:
                await self.close()
                raise
            except (ConnectionError, asyncio.IncompleteReadError, OSError):
                await self.close()
                if not reused:
                    raise
                self.retries += 1
                await asyncio.sleep(self.backoff_s * (1 + random.random()))
                continue  # stale pooled socket: one fresh-connection retry
            if hdrs.get("connection", "").lower() == "close":
                await self.close()
            return status, hdrs, data

    async def _json(
        self,
        method: str,
        path: str,
        body: Optional[dict] = None,
        headers: Optional[dict] = None,
    ) -> dict:
        status, _, data = await self.request(method, path, body, headers)
        obj = json.loads(data) if data else {}
        if status >= 400:
            raise HttpError(status, obj)
        return obj

    # -- API surface -----------------------------------------------------
    async def generate(
        self,
        prompt,
        max_new: Optional[int] = None,
        tenant: Optional[str] = None,
        deadline_ms: Optional[float] = None,
        debug: bool = False,
    ) -> dict:
        """``debug=True`` asks the server for the per-request phase
        breakdown (``phases`` key: queue/prefill/decode ms + cache
        savings) alongside the usual summary."""
        body: dict = {"prompt": [int(t) for t in prompt]}
        if max_new is not None:
            body["max_new"] = max_new
        if deadline_ms is not None:
            body["deadline_ms"] = deadline_ms
        if debug:
            body["debug"] = True
        return await self._json(
            "POST", "/v1/generate", body, self._headers(tenant)
        )

    async def stream(
        self,
        prompt,
        max_new: Optional[int] = None,
        tenant: Optional[str] = None,
        deadline_ms: Optional[float] = None,
        debug: bool = False,
    ) -> AsyncIterator[Tuple[str, dict]]:
        """Async iterator of SSE frames as ``(event, data)`` pairs: one
        ``("start", {"rid": ...})`` (the id to DELETE for a mid-stream
        ``cancel``), ``("message", {"index": i, "token": t})`` per token,
        then one ``("done", {...summary})`` — with ``"status":
        "cancelled"`` and the partial token count if the request was
        cancelled mid-stream. ``debug=True`` adds the ``phases``
        breakdown to the ``done`` payload. Raises HttpError on rejection
        — either pre-admission (the server answers with the mapped status
        instead of a stream) or post-admission (a terminal ``error``
        event carrying the mapped status, e.g. a deadline that expired
        while queued or mid-flight)."""
        body: dict = {"prompt": [int(t) for t in prompt]}
        if max_new is not None:
            body["max_new"] = max_new
        if deadline_ms is not None:
            body["deadline_ms"] = deadline_ms
        if debug:
            body["debug"] = True
        payload = json.dumps(body).encode("utf-8")
        reader, writer = await self._connect()  # dedicated conn per stream
        try:
            writer.write(
                _request_bytes(
                    "POST", "/v1/stream", self.host, payload,
                    self._headers(tenant),
                )
            )
            await writer.drain()
            status, hdrs = await asyncio.wait_for(
                _read_response_head(reader), self.timeout_s
            )
            if status >= 400:
                n = int(hdrs.get("content-length", 0))
                data = (
                    await asyncio.wait_for(reader.readexactly(n), self.timeout_s)
                    if n
                    else b""
                )
                raise HttpError(status, json.loads(data) if data else {})
            event, data_lines = "message", []
            while True:
                # per-frame cap: a server that dies (or a dropped socket
                # the kernel hasn't noticed) mid-stream surfaces as a
                # TimeoutError after timeout_s, not an eternal hang
                line = await asyncio.wait_for(reader.readline(), self.timeout_s)
                if not line:  # server closed: end of stream
                    return
                line = line.rstrip(b"\r\n").decode("utf-8")
                if not line:  # blank line terminates one SSE frame
                    if data_lines:
                        data = json.loads("\n".join(data_lines))
                        if event == "error":  # rejected after admission
                            raise HttpError(data.get("status", 500), data)
                        yield event, data
                        if event == "done":
                            return
                    event, data_lines = "message", []
                elif line.startswith("event:"):
                    event = line.split(":", 1)[1].strip()
                elif line.startswith("data:"):
                    data_lines.append(line.split(":", 1)[1].strip())
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def cancel(self, rid: int) -> dict:
        """DELETE /v1/requests/{rid}. Returns ``{"cancelled": true}`` on
        success; raises HttpError(404) for unknown/finished rids."""
        return await self._json("DELETE", f"/v1/requests/{int(rid)}")

    async def healthz(self) -> dict:
        status, _, data = await self.request("GET", "/healthz")
        obj = json.loads(data)
        if status >= 400 and obj.get("status") != "draining":
            raise HttpError(status, obj)
        return obj

    async def metrics(self) -> str:
        status, _, data = await self.request("GET", "/metrics")
        if status >= 400:
            raise HttpError(status, data.decode("utf-8", "replace"))
        return data.decode("utf-8")

    async def drain(self) -> dict:
        return await self._json("POST", "/admin/drain")

    async def trace(self) -> dict:
        """Chrome trace-event JSON from ``GET /admin/trace``: dump it to a
        file and open it in Perfetto."""
        return await self._json("GET", "/admin/trace")
