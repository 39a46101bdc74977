"""Typed error taxonomy, after ``repro.resilience.errors``.

The port keeps its own copy (it imports nothing of ``repro``).  The TPU's
``KernelLoweringError`` becomes ``KernelLaunchError``: a hand-written CUDA
kernel that fails to build, or whose launch the CUDA driver refuses; it is
the class the fallback ladder demotes on.  The VMEM residency class has no
counterpart: the port keeps no whole array resident in on-chip memory.
"""

from __future__ import annotations


class ResilienceError(Exception):
    """Base class of the taxonomy."""


class KernelLaunchError(ResilienceError, RuntimeError):
    """A CUDA kernel failed to build, or ``cudaGetLastError()`` reported a
    refused or failed launch."""


class BackendUnavailable(ResilienceError, RuntimeError):
    """No rung of the fallback ladder could build and probe a working
    resampler.  Carries the per-rung failures for the post-mortem."""

    def __init__(self, message: str, failures=()):
        super().__init__(message)
        #: ``[(backend, exception), ...]``, one entry per failed rung.
        self.failures = tuple(failures)


class CorruptAncestorsError(ResilienceError, ValueError):
    """An ancestor vector failed validation (an index out of range): the
    poisoned-ancestor fault class, caught at the consumer boundary instead
    of gathering the wrong state."""


class InjectedCrash(ResilienceError, RuntimeError):
    """The deterministic kill of the crash-consistency tests: raised by
    ``CheckpointPolicy(fail_after=k)`` right AFTER the snapshot that crosses
    step ``k`` is durably on disk, so a resumed run always finds a
    consistent checkpoint."""
