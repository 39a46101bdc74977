"""Typed error taxonomy, after ``repro.resilience.errors``.

The port keeps its own copy (it imports nothing of ``repro``) and carries
only the classes it raises.  The TPU's ``KernelLoweringError`` becomes
``KernelLaunchError``: a hand-written CUDA kernel that fails to build, or
whose launch the CUDA driver refuses.  The VMEM residency class has no
counterpart: the port keeps no whole array resident in on-chip memory.
"""

from __future__ import annotations


class ResilienceError(Exception):
    """Base class of the taxonomy."""


class KernelLaunchError(ResilienceError, RuntimeError):
    """A CUDA kernel failed to build, or ``cudaGetLastError()`` reported a
    refused or failed launch."""
