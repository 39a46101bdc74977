"""Backend fallback chains, the demotion ladder (DESIGN.md §16), after
``repro.resilience.fallback``.

``build_with_fallback(spec)`` tries the spec's own backend first, then
demotes rung by rung down the ladder (default ``cuda → reference``),
emitting one ``backend_demotion`` ``ResilienceEvent`` per failed rung, and
raises ``BackendUnavailable``, carrying every rung's cause, only when the
whole ladder is exhausted.  Demotion is strictly downward: a spec built for
``reference`` never promotes to ``cuda``.

It is opt-in: ``ResamplerSpec.build()`` never falls back, and no entry of
``pf/`` or ``ais/`` calls this.  A caller who wants a working resampler
whatever the host asks for it (``spec.build_resilient()``) and gets the
demotion as an event, never silently.

The probe (``probe_resampler``: a resample of ``PROBE_N`` uniform weights on ``device``, then
``torch.cuda.synchronize()``) catches a rung that builds but whose first
launch the card refuses: a kernel built for another architecture, a
library that does not load.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch import random as trandom
from repro_torch import resolve_device
from repro_torch.resilience.errors import (
    BackendUnavailable,
    KernelLaunchError,
    ResilienceError,
)
from repro_torch.resilience.guards import demotion_event, emit_event

#: The demotion order: the hand-written kernels first, the plain-torch
#: reference algorithms last.
DEFAULT_LADDER = ("cuda", "reference")

#: Probe geometry: two of the kernels' 1024-particle tiles, so every
#: family's tile-fixed kernel accepts it.
PROBE_N = 2048


def classify_backend_error(error: BaseException) -> ResilienceError:
    """Map a raw build or probe failure onto the typed taxonomy: a typed
    error passes through; anything else becomes ``KernelLaunchError`` (from
    the ladder's point of view every failure is "this rung cannot run
    here"), with the original as its ``__cause__``."""
    if isinstance(error, ResilienceError):
        return error
    wrapped = KernelLaunchError(f"{type(error).__name__}: {error}")
    wrapped.__cause__ = error
    return wrapped


def _ladder_for(backend: str, ladder: Optional[Sequence[str]]) -> Tuple[str, ...]:
    """The rungs to try: the spec's backend, then every ``DEFAULT_LADDER``
    rung below it (or the caller's ladder as given)."""
    if ladder is not None:
        rungs = tuple(ladder)
        if not rungs:
            raise ValueError("build_with_fallback: ladder must be non-empty")
        return rungs
    if backend not in DEFAULT_LADDER:
        return (backend,)
    return DEFAULT_LADDER[DEFAULT_LADDER.index(backend):]


def probe_resampler(resampler, device="cuda") -> None:
    """One small resample on ``device``: uniform weights over ``PROBE_N``
    particles under a fixed key (a clean bank, which no guard touches),
    then a synchronize, so that a refused launch surfaces here and not at
    first use."""
    dev = resolve_device(device)
    w = torch.full((PROBE_N,), 1.0 / PROBE_N, dtype=torch.float32, device=dev)
    resampler(trandom.PRNGKey(0), w)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _emit(recorder, event) -> None:
    if recorder is not None:
        emit_fn = getattr(recorder, "emit", None)
        if emit_fn is not None:
            fields = event.as_dict()
            emit_fn(fields.pop("kind"), **fields)
        else:
            recorder.append(event.as_dict())
    emit_event(event)


def build_with_fallback(spec, *, ladder=None, recorder=None, probe: bool = True,
                        device="cuda"):
    """Build ``spec`` with backend demotion (DESIGN.md §16).

    Returns the first rung's ``Resampler`` that builds and, with
    ``probe=True``, survives a resample on ``device``.  Every failed rung
    emits a ``backend_demotion`` event to ``recorder`` (``.emit`` or
    ``.append``, as the guard's recorder) and to any active
    ``record_resilience_events``.  Exhaustion raises ``BackendUnavailable``
    whose ``.failures`` holds each ``(backend, typed error)`` pair in
    demotion order."""
    rungs = _ladder_for(spec.backend, ladder)
    failures = []
    for i, rung in enumerate(rungs):
        nxt = rungs[i + 1] if i + 1 < len(rungs) else None
        try:
            candidate = spec if spec.backend == rung else spec.replace(backend=rung)
            resampler = candidate.build()
            if probe:
                probe_resampler(resampler, device)
            return resampler
        except Exception as err:  # noqa: BLE001 (classified, and raised typed at the end)
            typed = classify_backend_error(err)
            failures.append((rung, typed))
            _emit(recorder, demotion_event(spec.name, rung, nxt, typed))
    lines = "; ".join(f"{b}: {type(e).__name__}: {e}" for b, e in failures)
    raise BackendUnavailable(f"{spec.name}: every backend rung failed ({lines})",
                             failures=tuple(failures))
