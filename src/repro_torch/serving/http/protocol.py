"""Minimal HTTP/1.1 + Server-Sent-Events wire protocol over asyncio streams.

Counterpart of ``repro.serving.http.protocol``, and byte for byte the same
framing (stdlib only; the port keeps its own copy). Just enough of RFC 7230
to serve the JSON and SSE endpoints: request-line and header parsing,
Content-Length bodies, keep-alive, and SSE framing. Not a general web
server: no chunked *request* bodies, no multipart, no TLS (terminate
upstream); request targets are matched literally after stripping the
query string.

Framing rules this module implements:

* Requests: ``METHOD /path HTTP/1.1`` + CRLF headers + optional body of
  exactly ``Content-Length`` bytes. Header names are lower-cased on parse.
* JSON responses carry ``Content-Length`` and keep the connection alive
  unless the client sent ``Connection: close``.
* SSE responses (``Content-Type: text/event-stream``) have no length and
  are terminated by connection close (``Connection: close`` is announced
  in the preamble); each event is ``[event: <name>\\n]data: <payload>\\n\\n``.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
from typing import Any, Iterable, Optional, Tuple

__all__ = [
    "HttpRequest",
    "ProtocolError",
    "read_request",
    "render_response",
    "json_response",
    "sse_preamble",
    "sse_event",
    "STATUS_PHRASES",
]

MAX_REQUEST_LINE = 8 * 1024
MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 8 * 2**20

STATUS_PHRASES = {
    200: "OK",
    202: "Accepted",
    400: "Bad Request",
    404: "Not Found",
    405: "Method Not Allowed",
    413: "Payload Too Large",
    429: "Too Many Requests",
    500: "Internal Server Error",
    503: "Service Unavailable",
    504: "Gateway Timeout",
}


class ProtocolError(Exception):
    """Malformed or oversized request; ``status`` is the HTTP status the
    server should answer with before closing the connection."""

    def __init__(self, status: int, detail: str):
        super().__init__(detail)
        self.status = status
        self.detail = detail


@dataclasses.dataclass
class HttpRequest:
    method: str
    target: str  # raw request target, query string included
    headers: dict  # lower-cased names -> values
    body: bytes

    @property
    def path(self) -> str:
        return self.target.split("?", 1)[0]

    @property
    def keep_alive(self) -> bool:
        return self.headers.get("connection", "").lower() != "close"

    def json(self) -> Any:
        """Parse the body as a JSON object; raises ProtocolError(400)."""
        if not self.body:
            raise ProtocolError(400, "empty body: expected a JSON object")
        try:
            obj = json.loads(self.body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            raise ProtocolError(400, f"malformed JSON body: {e}") from None
        if not isinstance(obj, dict):
            raise ProtocolError(400, "JSON body must be an object")
        return obj


async def read_request(reader: asyncio.StreamReader) -> Optional[HttpRequest]:
    """Read one request off the stream; None on clean EOF (client closed
    between keep-alive requests). Raises ProtocolError on malformed input
    and ConnectionError/IncompleteReadError on mid-request disconnects."""
    try:
        line = await reader.readuntil(b"\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None  # clean close between requests
        raise ConnectionError("connection closed mid request line") from None
    except asyncio.LimitOverrunError:
        raise ProtocolError(400, "request line too long") from None
    if len(line) > MAX_REQUEST_LINE:
        raise ProtocolError(400, "request line too long")
    parts = line.decode("latin-1").rstrip("\r\n").split()
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise ProtocolError(400, f"malformed request line: {line!r}")
    method, target, _version = parts

    headers: dict = {}
    total = 0
    while True:
        try:
            line = await reader.readuntil(b"\r\n")
        except asyncio.IncompleteReadError:
            raise ConnectionError("connection closed mid headers") from None
        except asyncio.LimitOverrunError:
            # one header line longer than the StreamReader buffer limit:
            # answer 400 instead of killing the connection task
            raise ProtocolError(400, "header line too long") from None
        if line in (b"\r\n", b"\n"):
            break
        total += len(line)
        if total > MAX_HEADER_BYTES:
            raise ProtocolError(400, "headers too large")
        name, sep, value = line.decode("latin-1").partition(":")
        if not sep:
            raise ProtocolError(400, f"malformed header line: {line!r}")
        headers[name.strip().lower()] = value.strip()

    body = b""
    if "content-length" in headers:
        try:
            n = int(headers["content-length"])
        except ValueError:
            raise ProtocolError(400, "bad Content-Length") from None
        if n < 0:
            raise ProtocolError(400, "bad Content-Length")
        if n > MAX_BODY_BYTES:
            raise ProtocolError(413, f"body exceeds {MAX_BODY_BYTES} bytes")
        try:
            body = await reader.readexactly(n)
        except asyncio.IncompleteReadError:
            raise ConnectionError("connection closed mid body") from None
    elif headers.get("transfer-encoding", "").lower() == "chunked":
        raise ProtocolError(400, "chunked request bodies are not supported")
    return HttpRequest(method=method, target=target, headers=headers, body=body)


def render_response(
    status: int,
    body: bytes,
    content_type: str = "application/json",
    extra_headers: Iterable[Tuple[str, str]] = (),
    keep_alive: bool = True,
) -> bytes:
    phrase = STATUS_PHRASES.get(status, "Unknown")
    lines = [
        f"HTTP/1.1 {status} {phrase}",
        f"Content-Type: {content_type}",
        f"Content-Length: {len(body)}",
        f"Connection: {'keep-alive' if keep_alive else 'close'}",
    ]
    lines += [f"{k}: {v}" for k, v in extra_headers]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body


def json_response(
    status: int,
    obj: Any,
    extra_headers: Iterable[Tuple[str, str]] = (),
    keep_alive: bool = True,
) -> bytes:
    body = (json.dumps(obj) + "\n").encode("utf-8")
    return render_response(
        status, body, extra_headers=extra_headers, keep_alive=keep_alive
    )


def sse_preamble(status: int = 200) -> bytes:
    """Response head for a Server-Sent-Events stream. No Content-Length:
    the stream is delimited by connection close, announced up front."""
    phrase = STATUS_PHRASES.get(status, "Unknown")
    return (
        f"HTTP/1.1 {status} {phrase}\r\n"
        "Content-Type: text/event-stream\r\n"
        "Cache-Control: no-store\r\n"
        "Connection: close\r\n\r\n"
    ).encode("latin-1")


def sse_event(data: Any, event: Optional[str] = None) -> bytes:
    """One SSE frame. ``data`` is JSON-encoded (the wire format ``Client``
    parses); a named event becomes an ``event:`` field."""
    head = f"event: {event}\n" if event else ""
    return (head + f"data: {json.dumps(data)}\n\n").encode("utf-8")
