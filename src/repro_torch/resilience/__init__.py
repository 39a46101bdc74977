"""Resilience layer of the port (DESIGN.md §16): the error taxonomy and the
degeneracy guard's policy and event recorder."""

from repro_torch.resilience.errors import KernelLaunchError, ResilienceError
from repro_torch.resilience.guards import (
    GUARD_POLICIES,
    ResilienceEvent,
    check_guard_policy,
    classify_step_stats,
    demotion_event,
    emit_event,
    guard_events_enabled,
    maybe_emit_guard_event,
    record_resilience_events,
)

__all__ = [
    "GUARD_POLICIES",
    "KernelLaunchError",
    "ResilienceError",
    "ResilienceEvent",
    "check_guard_policy",
    "classify_step_stats",
    "demotion_event",
    "emit_event",
    "guard_events_enabled",
    "maybe_emit_guard_event",
    "record_resilience_events",
]
