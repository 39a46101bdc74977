"""Per-step diagnostics of the port and its flight recorder."""

from repro_torch.obs.sink import JsonlSink
from repro_torch.obs.stats import StepStats, stats_from_vector
from repro_torch.obs.telemetry import Telemetry

__all__ = ["JsonlSink", "StepStats", "Telemetry", "stats_from_vector"]
