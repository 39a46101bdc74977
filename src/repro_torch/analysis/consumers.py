"""Contracts of the stack's resampler consumers (DESIGN.md §13), after
``repro.analysis.consumers``: the particle filter's part.

The matrix audit proves each entry point honest alone; this module proves
the filter kept its promises after composition ("one fused launch per
filter step", "ancestors never round-trip through device memory", no RNG
finding), re-derived from runs of ``ParticleFilter.step`` and
``step_conditional`` and of the drivers ``run_filter`` and
``run_filter_bank`` (conditional SIR) on a Megopolis spec at the audit's
geometry.  JAX's scan counts its body once; the port runs eagerly, so T
observations launch T kernels: the budget is one launch per step.  The AIS
and decode consumers come with their ports (ROADMAP Queue A items 8 and
11), and so does the adaptive-iteration reference sweep (item 4).
"""

from __future__ import annotations

import torch

from repro_torch import random as trandom
from repro_torch import resolve_device
from repro_torch.analysis.contracts import (
    AUDIT_BATCH,
    AUDIT_N,
    AUDIT_NUM_ITERS,
    Contract,
    audit_program,
)
from repro_torch.core.spec import MegopolisSpec

#: Observations of the driver runs.
AUDIT_STEPS = 5


def _pf(conditional: bool):
    from repro_torch.pf.filter import ParticleFilter
    from repro_torch.pf.models import ungm

    return ParticleFilter(model=ungm(), num_particles=AUDIT_N,
                          resampler=MegopolisSpec(num_iters=AUDIT_NUM_ITERS),
                          ess_threshold=0.5 if conditional else None)


def _programs(device):
    """name -> (program, steps)."""
    from repro_torch.pf.filter import run_filter, run_filter_bank

    dev = resolve_device(device)
    key = trandom.PRNGKey(0)
    x = torch.zeros(AUDIT_N, device=dev)
    lw = torch.zeros(AUDIT_N, device=dev)
    z, t = torch.tensor(0.5, device=dev), torch.tensor(1.0, device=dev)
    obs = torch.zeros(AUDIT_STEPS)
    return {
        "pf.step": (lambda: _pf(False).step(key, x, z, t), 1),
        "pf.step_conditional": (lambda: _pf(True).step_conditional(key, x, lw, z, t), 1),
        "pf.run_filter": (lambda: run_filter(key, _pf(True), obs, device=dev), AUDIT_STEPS),
        "pf.run_filter_bank": (
            lambda: run_filter_bank(key, _pf(True), torch.zeros(AUDIT_BATCH, AUDIT_STEPS),
                                    device=dev), AUDIT_STEPS),
    }


def audit_consumers(names=None, device="cuda", around=None):
    """Run and audit each consumer program, one launch per step; returns a
    generator of CellReports (``cuda`` without a card raises here, before
    the first)."""
    programs = _programs(device)
    return (audit_program(name, programs[name][0], Contract(max_launches=programs[name][1]),
                          around=around) for name in names or programs)
