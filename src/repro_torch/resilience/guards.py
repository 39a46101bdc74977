"""Degeneracy-guard policy and the structured resilience-event recorder
(DESIGN.md §16), after ``repro.resilience.guards``.

``guard`` is a spec axis (``ResamplerSpec.guard``), not a runtime switch:

  * ``'off'``     — the unguarded program.
  * ``'flag'``    — the SAME torch calls as ``'off'`` (the degenerate flag is
                    composed into ``StepStats`` under every policy), plus one
                    ``ResilienceEvent`` per call that saw a collapsed row,
                    and only while a recorder is active: without one,
                    ``'flag'`` adds no op and no wait on the card.
  * ``'recover'`` — degenerate rows are replaced by the uniform bank BEFORE
                    dispatch (``torch.where``, an exact pass-through on
                    clean rows), so every backend runs the same recovered
                    resample with the same key: the key is consumed alike
                    and the outputs are finite whatever was fed in.

The JAX package stages its event as a ``jax.debug.callback`` at trace time;
the port runs eagerly, so a guarded entry reads its degenerate flag on the
host (one sync) and emits at once, but only while a recorder is active.
"""

from __future__ import annotations

import dataclasses
import difflib
from contextlib import contextmanager
from typing import Any, Dict, Optional, Tuple

#: The spec-axis vocabulary, validated eagerly by every spec.
GUARD_POLICIES = ("off", "flag", "recover")


def check_guard_policy(value, who: str) -> None:
    """Eager spec validation (the same messages as the JAX package's)."""
    if value not in GUARD_POLICIES:
        hint = difflib.get_close_matches(str(value), GUARD_POLICIES, n=1)
        did_you_mean = f" — did you mean {hint[0]!r}?" if hint else ""
        raise ValueError(
            f"{who}.guard must be one of {list(GUARD_POLICIES)}; "
            f"got {value!r}{did_you_mean}"
        )


@dataclasses.dataclass(frozen=True)
class ResilienceEvent:
    """One structured resilience occurrence for the JSONL flight recorder.

    ``kind`` is the taxonomy key: ``guard_degenerate`` (a collapsed bank
    hit a guarded entry), ``backend_demotion`` (a fallback ladder moved
    down a rung), ``fault_injected`` (a chaos harness seeded a fault).
    """

    kind: str
    family: str = ""
    backend: str = ""
    entry: str = ""
    policy: str = ""
    detail: Tuple[Tuple[str, Any], ...] = ()

    def as_dict(self) -> Dict[str, Any]:
        d = {
            "kind": self.kind,
            "family": self.family,
            "backend": self.backend,
            "entry": self.entry,
            "policy": self.policy,
        }
        d.update(dict(self.detail))
        return d


# Active recorders, LIFO.  A recorder is anything with ``.emit(event,
# **fields)`` (``obs.sink.JsonlSink``) or ``.append(dict)`` (a plain list).
_RECORDERS: list = []


@contextmanager
def record_resilience_events(recorder):
    """Deliver the resilience events of the dynamic extent to ``recorder``."""
    _RECORDERS.append(recorder)
    try:
        yield recorder
    finally:
        _RECORDERS.remove(recorder)


def guard_events_enabled() -> bool:
    return bool(_RECORDERS)


def emit_event(event: ResilienceEvent) -> None:
    """Deliver one event to every active recorder."""
    payload = event.as_dict()
    for rec in list(_RECORDERS):
        emit = getattr(rec, "emit", None)
        if emit is not None:
            fields = dict(payload)
            emit(fields.pop("kind"), **fields)
        else:
            rec.append(payload)


def maybe_emit_guard_event(family: str, backend: str, entry: str, policy: str,
                           degenerate) -> None:
    """The guard's flight-recorder evidence: one ``guard_degenerate`` event
    for a call that saw a collapsed row (``degenerate`` a bool tensor, or a
    callable giving it), and nothing, not even the flag's computation, while
    no recorder is active."""
    if not _RECORDERS:
        return
    deg = degenerate() if callable(degenerate) else degenerate
    count = int(deg.sum())
    if count:
        emit_event(ResilienceEvent(
            kind="guard_degenerate", family=family, backend=backend,
            entry=entry, policy=policy,
            detail=(("degenerate_rows", count), ("bank_rows", max(int(deg.numel()), 1))),
        ))


def classify_step_stats(stats, n: int) -> Dict[str, bool]:
    """Host-side degeneracy classification of one concrete ``StepStats``
    record: the three §16 collapse signatures the guard watches:

      * ``degenerate``      — a non-finite bank (all ``-inf``/nan/±inf);
      * ``ess_floor``       — ESS at its 1/N floor (mass on one particle);
      * ``single_survivor`` — the ancestor vector kept one lineage.
    """
    ess_norm = float(stats.ess_norm)
    survivors = int(stats.survivors)
    degenerate = bool(stats.degenerate)
    floor = ess_norm <= (1.0 + 1e-6) / n
    return {
        "degenerate": degenerate,
        "ess_floor": floor,
        "single_survivor": survivors <= 1,
        "any": degenerate or floor or survivors <= 1,
    }


def demotion_event(family: str, from_backend: str, to_backend: Optional[str],
                   error: BaseException) -> ResilienceEvent:
    """A fallback ladder's per-rung evidence (``backend_demotion``)."""
    return ResilienceEvent(
        kind="backend_demotion", family=family, backend=from_backend,
        entry="build",
        detail=(("to_backend", to_backend or ""),
                ("error_type", type(error).__name__),
                ("error", str(error)[:500])),
    )
