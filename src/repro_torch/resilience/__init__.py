"""Error taxonomy of the port (the subset this slice raises)."""

from repro_torch.resilience.errors import KernelLaunchError, ResilienceError

__all__ = ["KernelLaunchError", "ResilienceError"]
