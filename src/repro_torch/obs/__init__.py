"""Observability of the port.

  * ``obs.trace`` (stdlib-only): the span tracer the serving stack threads
    through the request lifecycle, exported as Chrome trace-event JSON
    (counterpart of ``repro.obs.trace``).
  * ``obs.costmodel`` (stdlib-only): the analytical kernel cost model and
    the ledger that joins it with measured times (counterpart of
    ``repro.obs.costmodel``); ``kernels.dispatch.LEDGER`` is the instance
    every dispatched call feeds.
  * ``obs.telemetry``: the quantization-health telemetry of FloatSD8/FP8
    training (counterpart of ``repro.obs.telemetry``); import the
    submodule directly.
"""
from .costmodel import ZERO_COST, Cost, CostLedger, CostSpec, merge_costs  # noqa: F401
from .trace import TRACER, Tracer  # noqa: F401

__all__ = ["TRACER", "Tracer", "Cost", "CostSpec", "CostLedger", "merge_costs", "ZERO_COST"]
