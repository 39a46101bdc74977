"""Profiler spans over dispatch boundaries, after ``repro.obs.trace``
(DESIGN.md §15).

``span(name)`` wraps a region in ``torch.profiler.record_function(name)``,
so the host-side work lands under ``name`` on a ``torch.profiler``
timeline and the kernels it launches nest under it, and in an NVTX range
of the same name where the CUDA build has NVTX (``torch.cuda.nvtx``), for
tools that read those.  ``Resampler`` dispatch opens one per public entry,
named::

    family/backend/entry/plane_dtype     e.g. megopolis/cuda/step/float32

Disabled (the default) a span is an identity context manager: no profiler
call, no NVTX call.  Enabled or not, a span launches nothing on the card,
so the launch census (``python -m repro_torch.analysis --check``, pass 6)
is the same either way.  Enable with ``REPRO_TRACE=1`` in the environment
or ``enable_tracing()`` in code.
"""

from __future__ import annotations

import contextlib
import os

import torch

_enabled = os.environ.get("REPRO_TRACE", "0") not in ("", "0", "false", "no")


def enable_tracing(on: bool = True) -> None:
    """Turn span emission on or off process-wide (overrides ``REPRO_TRACE``)."""
    global _enabled
    _enabled = bool(on)


def tracing_enabled() -> bool:
    return _enabled


def _nvtx_range(name: str):
    """An NVTX range on a CUDA build with a card, else nothing."""
    if torch.cuda.is_available():
        return torch.cuda.nvtx.range(name)
    return contextlib.nullcontext()


@contextlib.contextmanager
def span(name: str):
    """A profiler span (and NVTX range) around a region; identity when
    disabled."""
    if not _enabled:
        yield
        return
    with torch.profiler.record_function(name), _nvtx_range(name):
        yield


def dispatch_span(family: str, backend: str, entry: str, plane_dtype="float32"):
    """The dispatch span: ``family/backend/entry/plane_dtype``."""
    return span(f"{family}/{backend}/{entry}/{plane_dtype}")
