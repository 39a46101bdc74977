"""Contracts of the stack's resampler consumers (DESIGN.md §13), after
``repro.analysis.consumers``: the particle filter's, the AIS sampler's and
SMC decoding's.

The matrix audit proves each entry point honest alone; this module proves
the consumers kept their promises after composition ("one fused launch per
step", "ancestors never round-trip through device memory", no RNG
finding), re-derived from runs of ``ParticleFilter.step`` and
``step_conditional``, of the drivers ``run_filter`` and ``run_filter_bank``
(conditional SIR), and of ``run_smc_sampler`` (geometric, and adaptive
with MALA) and ``run_smc_sampler_bank`` on ``gaussian_mixture``, all on a
Megopolis spec at the audit's geometry.  JAX's scan counts its body once;
the port runs eagerly, so T steps (observations, temperatures) launch T
kernels: the budget is one launch per step, and under the adaptive ladder
``ais.schedule.ADAPTIVE_LAUNCHES`` more a temperature (the CESS bisection's
``logsumexp_rows``, whose order a bank row shares with its single call).
``smc.decode`` runs ``smc_decode`` on the qwen3 smoke config at
``DECODE_PARTICLES`` (the kernels' tile): one launch a decode step, and it
is the one consumer whose contract allows the ancestor-indexed gather (of
every KV-cache leaf), as the JAX package's ``allow_tainted_gather=True``.

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
from repro_torch.ais.schedule import ADAPTIVE_LAUNCHES
from repro_torch.analysis.rng import rng_findings
from repro_torch.core.spec import MegopolisSpec, spec_for_backend

#: Observations of the driver runs.
AUDIT_STEPS = 5
#: Temperatures of the AIS runs (the JAX auditor's).
AUDIT_TEMPS = 4

#: Decode needs N % 1024 == 0 on the kernel backend (the JAX auditor's).
DECODE_PARTICLES = 1024
#: Decode steps of the audited run (the JAX auditor's ``max_new_tokens``).
DECODE_STEPS = 3
#: The consumers whose contract allows the ancestor-indexed gather.
GATHER_CONSUMERS = ("smc.decode",)

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


def _decode(dev):
    """``smc_decode`` on the qwen3 smoke config in float32 at
    ``DECODE_PARTICLES`` particles, ``DECODE_STEPS`` tokens after a prompt
    of 4, on a Megopolis spec at the audit's B; the params, the prompt's
    caches and the first tokens are made before the audited run, which
    decodes on a copy of the caches."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import init_params, prefill
    from repro_torch.smc import SMCDecodeConfig, smc_decode

    cfg = dataclasses.replace(get_arch("qwen3-0.6b").smoke, dtype=torch.float32, remat=False)
    smc_cfg = SMCDecodeConfig(num_particles=DECODE_PARTICLES, max_new_tokens=DECODE_STEPS,
                              resampler=MegopolisSpec(num_iters=AUDIT_NUM_ITERS))
    prompt_len = 4
    params = init_params(trandom.PRNGKey(0), cfg, device=dev)
    prompts = torch.zeros((DECODE_PARTICLES, prompt_len), dtype=torch.int32, device=dev)
    caches = prefill(params, cfg, prompts, prompt_len + DECODE_STEPS)[1]
    first = torch.zeros((DECODE_PARTICLES,), dtype=torch.int32, device=dev)

    def program():
        fresh = [{"kv": tuple(c.clone() for c in layer["kv"])} for layer in caches]
        return smc_decode(params, cfg, smc_cfg, fresh, first, prompt_len - 1, trandom.PRNGKey(1))

    return program


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
        "ais.adaptive_mala": (_ais(dev, schedule="adaptive", move="mala"),
                              AUDIT_TEMPS * (1 + ADAPTIVE_LAUNCHES)),
        "smc.decode": (_decode(dev), DECODE_STEPS),
    }


def audit_consumers(names=None, device="cuda", around=None):
    """Run and audit each consumer program, one launch per step (per
    temperature for AIS, plus the adaptive schedule's; per token for
    decoding); returns a generator of CellReports (``cuda`` without a card
    raises here, before the first)."""
    programs = _programs(device)
    return (audit_program(name, programs[name][0],
                          Contract(max_launches=programs[name][1],
                                   allow_tainted_gather=name in GATHER_CONSUMERS),
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
