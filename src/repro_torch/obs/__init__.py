"""Per-step diagnostics of the port."""

from repro_torch.obs.stats import StepStats, stats_from_vector
from repro_torch.obs.telemetry import Telemetry

__all__ = ["StepStats", "Telemetry", "stats_from_vector"]
