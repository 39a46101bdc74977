"""Per-step diagnostics of the port, its flight recorder and its profiler
spans."""

from repro_torch.obs.sink import JsonlSink
from repro_torch.obs.stats import StepStats, stats_from_vector
from repro_torch.obs.telemetry import Telemetry
from repro_torch.obs.trace import dispatch_span, enable_tracing, span, tracing_enabled

__all__ = ["JsonlSink", "StepStats", "Telemetry", "dispatch_span", "enable_tracing", "span",
           "stats_from_vector", "tracing_enabled"]
