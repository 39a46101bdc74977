"""Pass 6: telemetry neutrality (DESIGN.md §15), after
``repro.analysis.telemetry``.

Observability is FREE: flipping ``telemetry=True`` on a consumer must not
add a single kernel launch, and must leave the estimates (and so the
ancestor stream feeding them) untouched.  The JAX pass compares two traces,
the second dead-code eliminated down to its estimates; an eager program has
no such projection, so the port runs ``run_filter`` twice on the same key,
telemetry off and on, and compares what the runs did:

  * **launch parity**: the kernel census of the two runs must be EQUAL;
  * **estimate parity**: the estimates must be bit-identical.

The conditional-SIR ``run_filter`` is the probe because it runs the fused
``Resampler.step``, whose stats feed both the resample decision and the
telemetry record.
"""

from __future__ import annotations

import torch

from repro_torch import random as trandom
from repro_torch import resolve_device
from repro_torch.analysis.contracts import record
from repro_torch.core.spec import list_resamplers, spec_for_backend

#: Probe geometry, the JAX pass's: N is two tiles.
NEUTRALITY_N = 2048
NEUTRALITY_STEPS = 3
NEUTRALITY_NUM_ITERS = 16
NEUTRALITY_MAX_ITERS = 64


def _probe_filter(name: str):
    from repro_torch.pf.filter import ParticleFilter
    from repro_torch.pf.models import ungm

    spec = spec_for_backend(name, "cuda", num_iters=NEUTRALITY_NUM_ITERS,
                            max_iters=NEUTRALITY_MAX_ITERS)
    return ParticleFilter(model=ungm(), num_particles=NEUTRALITY_N, resampler=spec,
                          ess_threshold=0.5)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.detach().float().cpu().contiguous().view(torch.int32)


def compare_runs(cell: str, off, on) -> dict:
    """Grade an (off, on) pair of recorded runs, each ``(estimates,
    Recording)``, for neutrality."""
    (est_off, rec_off), (est_on, rec_on) = off, on
    launches_off, launches_on = dict(rec_off.census), dict(rec_on.census)
    match = est_off.shape == est_on.shape and torch.equal(_bits(est_off), _bits(est_on))
    violations = []
    if launches_on != launches_off:
        violations.append(
            f"telemetry=True changed the kernel launch census: {launches_off} off vs "
            f"{launches_on} on (the record must be composed from values the filter already "
            "computes, DESIGN.md §15)")
    if not match:
        violations.append(
            "telemetry=True perturbed the estimates: the telemetry-on run's estimates are not "
            "bit-identical to the telemetry-off run's on the same key (the ancestor/estimate "
            "stream must be byte-identical, DESIGN.md §15)")
    return {
        "cell": cell,
        "ok": not violations,
        "launches_off": sum(launches_off.values()),
        "launches_on": sum(launches_on.values()),
        "estimates_match": match,
        "violations": violations,
    }


def audit_telemetry_cell(name: str, device="cuda", around=None) -> dict:
    """Audit one family's ``run_filter`` for neutrality."""
    from repro_torch.pf.filter import run_filter

    device = resolve_device(device)
    pf = _probe_filter(name)
    key = trandom.PRNGKey(0)
    obs = torch.zeros(NEUTRALITY_STEPS)

    def run(telemetry):
        out = run_filter(key, pf, obs, telemetry=telemetry, device=device)
        return out[0] if telemetry else out

    off = record(lambda: run(False), around=around)
    on = record(lambda: run(True), around=around)
    return compare_runs(f"{name}/cuda/run_filter", off, on)


def audit_telemetry(families=None, device="cuda", around=None):
    """Audit neutrality across the families; returns a generator of cell
    dicts (``cuda`` without a card raises here, before the first)."""
    device = resolve_device(device)
    return (audit_telemetry_cell(name, device, around)
            for name in (families if families is not None else list_resamplers()))
