"""Observability of the port: ``obs.telemetry``, the quantization-health
telemetry of FloatSD8/FP8 training (counterpart of ``repro.obs.telemetry``).
Import the submodule directly."""
