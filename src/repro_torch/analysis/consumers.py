"""Contracts of the stack's resampler consumers (DESIGN.md §13), after
``repro.analysis.consumers``: the particle filter's and the AIS sampler's.

The matrix audit proves each entry point honest alone; this module proves
the consumers kept their promises after composition ("one fused launch per
step", "ancestors never round-trip through device memory", no RNG
finding), re-derived from runs of ``ParticleFilter.step`` and
``step_conditional``, of the drivers ``run_filter`` and ``run_filter_bank``
(conditional SIR), and of ``run_smc_sampler`` (geometric, and adaptive
with MALA) and ``run_smc_sampler_bank`` on ``gaussian_mixture``, all on a
Megopolis spec at the audit's geometry.  JAX's scan counts its body once;
the port runs eagerly, so T steps (observations, temperatures) launch T
kernels: the budget is one launch per step.  The decode consumer comes
with its port (ROADMAP Queue A item 11).

``auto_reference_rng`` sweeps the adaptive-``num_iters`` reference paths
through the RNG pass.  Megopolis's documented deliberate deviation, the
spec and ``megopolis()`` deriving the SAME offsets split so that injected
offsets reproduce the 'auto' stream, is waived, not hidden: the waiver's
reason lands in the report.
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
    Waiver,
    audit_program,
    record,
)
from repro_torch.analysis.rng import rng_findings
from repro_torch.core.spec import MegopolisSpec, spec_for_backend

#: Observations of the driver runs.
AUDIT_STEPS = 5
#: Temperatures of the AIS runs (the JAX auditor's).
AUDIT_TEMPS = 4

#: Direct (iterate-and-compare) families whose reference path takes the
#: adaptive iteration rule; swept by ``auto_reference_rng``.
AUTO_FAMILIES = ("megopolis", "metropolis", "metropolis_c1", "metropolis_c2")

MEGOPOLIS_AUTO_WAIVER = Waiver(
    code="key-reuse",
    match="split, split",
    reason=(
        "megopolis 'auto' reference: the spec splits the key for the offsets draw and "
        "megopolis() re-splits identically BY DESIGN, so injecting the drawn offsets "
        "reproduces the same derivation (core/resamplers/megopolis.py, the JAX "
        "package's streams)"
    ),
)


def _pf(conditional: bool):
    from repro_torch.pf.filter import ParticleFilter
    from repro_torch.pf.models import ungm

    return ParticleFilter(model=ungm(), num_particles=AUDIT_N,
                          resampler=MegopolisSpec(num_iters=AUDIT_NUM_ITERS),
                          ess_threshold=0.5 if conditional else None)


def _ais(dev, bank: bool = False, **overrides):
    """An AIS run on ``gaussian_mixture`` at ``AUDIT_N`` particles and
    ``AUDIT_TEMPS`` temperatures (a bank of ``AUDIT_BATCH`` rows)."""
    from repro_torch.ais import (
        SMCSamplerConfig,
        gaussian_mixture,
        run_smc_sampler,
        run_smc_sampler_bank,
    )

    cfg = SMCSamplerConfig(num_particles=AUDIT_N, num_temps=AUDIT_TEMPS,
                           resampler=MegopolisSpec(num_iters=AUDIT_NUM_ITERS), **overrides)
    target, key = gaussian_mixture(device=dev), trandom.PRNGKey(0)
    if bank:
        return lambda: run_smc_sampler_bank(key, target, cfg, num_scenarios=AUDIT_BATCH,
                                            device=dev)
    return lambda: run_smc_sampler(key, target, cfg, device=dev)


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
        "ais.run_smc_sampler": (_ais(dev), AUDIT_TEMPS),
        "ais.run_smc_sampler_bank": (_ais(dev, bank=True), AUDIT_TEMPS),
        "ais.adaptive_mala": (_ais(dev, schedule="adaptive", move="mala"), AUDIT_TEMPS),
    }


def audit_consumers(names=None, device="cuda", around=None):
    """Run and audit each consumer program, one launch per step (per
    temperature for AIS); returns a generator of CellReports (``cuda``
    without a card raises here, before the first)."""
    programs = _programs(device)
    return (audit_program(name, programs[name][0], Contract(max_launches=programs[name][1]),
                          around=around) for name in names or programs)


def auto_reference_rng(families=AUTO_FAMILIES, device="cuda"):
    """RNG-check the adaptive-iteration reference paths, one call each on
    uniform weights; yields ``(cell, kept findings, waived)`` triples."""
    dev = resolve_device(device)
    key = trandom.PRNGKey(0)
    w = torch.full((AUDIT_N,), 1.0 / AUDIT_N, device=dev)
    for name in families:
        resampler = spec_for_backend(name, "reference", num_iters="auto").build()
        kept, waived = [], []
        for f in rng_findings(record(lambda: resampler(key, w), taint=False)[1].keys):
            if name == "megopolis" and MEGOPOLIS_AUTO_WAIVER.covers(f):
                waived.append({"finding": f.as_dict(), "reason": MEGOPOLIS_AUTO_WAIVER.reason})
            else:
                kept.append(f)
        yield f"{name}/reference/auto", kept, waived
