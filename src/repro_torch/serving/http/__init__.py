"""repro_torch.serving.http: the stdlib HTTP/SSE network service over the
router (counterpart of ``repro.serving.http``).

``HttpServer`` exposes /v1/generate (JSON), /v1/stream (SSE),
DELETE /v1/requests/{rid}, /healthz, /metrics (Prometheus), /admin/drain
and /admin/trace over ``asyncio.start_server``; ``Client`` is the matching
stdlib client.
"""
from .client import Client, HttpError
from .prometheus import render_metrics
from .server import REASON_STATUS, HttpServer

__all__ = ["HttpServer", "Client", "HttpError", "REASON_STATUS", "render_metrics"]
