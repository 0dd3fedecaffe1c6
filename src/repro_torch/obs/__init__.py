"""Observability of the port.

  * ``obs.trace`` (stdlib-only): the span tracer the serving stack threads
    through the request lifecycle, exported as Chrome trace-event JSON
    (counterpart of ``repro.obs.trace``).
  * ``obs.telemetry``: the quantization-health telemetry of FloatSD8/FP8
    training (counterpart of ``repro.obs.telemetry``); import the
    submodule directly.
"""
from .trace import TRACER, Tracer  # noqa: F401

__all__ = ["TRACER", "Tracer"]
