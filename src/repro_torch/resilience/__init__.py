"""Resilience layer of the port (DESIGN.md §16): the error taxonomy, the
degeneracy guard's policy and event recorder, the backend fallback ladder,
deterministic fault injection and crash-consistent long runs."""

from repro_torch.resilience.checkpointing import CheckpointPolicy, checkpointed_scan
from repro_torch.resilience.errors import (
    BackendUnavailable,
    CorruptAncestorsError,
    InjectedCrash,
    KernelLaunchError,
    ResilienceError,
)
from repro_torch.resilience.fallback import (
    DEFAULT_LADDER,
    build_with_fallback,
    classify_backend_error,
)
from repro_torch.resilience.faults import (
    FAULT_CLASSES,
    bitflip_states,
    inject_inf_weights,
    inject_nan_weights,
    poison_ancestors,
    validate_ancestors,
)
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
    "DEFAULT_LADDER",
    "FAULT_CLASSES",
    "GUARD_POLICIES",
    "BackendUnavailable",
    "CheckpointPolicy",
    "CorruptAncestorsError",
    "InjectedCrash",
    "KernelLaunchError",
    "ResilienceError",
    "ResilienceEvent",
    "bitflip_states",
    "build_with_fallback",
    "check_guard_policy",
    "checkpointed_scan",
    "classify_backend_error",
    "classify_step_stats",
    "demotion_event",
    "emit_event",
    "guard_events_enabled",
    "inject_inf_weights",
    "inject_nan_weights",
    "maybe_emit_guard_event",
    "poison_ancestors",
    "record_resilience_events",
    "validate_ancestors",
]
