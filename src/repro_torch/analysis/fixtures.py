"""Deliberately broken programs that prove each pass of the contract checks
fires, after ``repro.analysis.fixtures``.

A checker that has never caught anything is indistinguishable from one that
checks nothing, so every pass ships with a program that violates exactly
its invariant and honours the others.  ``tests/test_torch_analysis.py``
holds the one-finding-per-fixture mapping to the "expected pass" column of
the JAX package's ``FIXTURES``, and ``--selftest`` re-runs it.

The programs use the port's two fixture kernels (``kernels/fixtures``), which
are right in themselves: ``copy_launch`` (``o = x``) and ``iota_launch``
(``int32[1, N] = 0..N-1``).  ``oversized_vmem`` is priced and never
launched.  ``leaky_guard`` is pass 7's (``analysis/guards.py``): a step
whose guard axis is not neutral in all three of its ways.
"""

from __future__ import annotations

import torch

from repro_torch import random as trandom
from repro_torch import resolve_device
from repro_torch.analysis import smem
from repro_torch.analysis.contracts import Contract, audit_program, record
from repro_torch.kernels.fixtures.fixtures import copy_launch, iota_launch

_N = 2048
#: The oversized fixture's length: 8M f32, 32 MiB.
_OVERSIZED_N = 1 << 23


def extra_launch(w):
    """Budget says ONE launch; this stages the copy through a second kernel,
    the unfused two-pass shape the launch census exists to catch."""
    return copy_launch(copy_launch(w))


def hbm_roundtrip(w, state):
    """Ancestors leave a kernel and index a gather outside any kernel, the
    §11 round trip through device memory that the fused apply and step
    removed."""
    idx = iota_launch(w)[0]
    return torch.index_select(state, 0, idx)


def reused_key(key, w):
    """The same key drawn from twice: correlated streams, the silent failure
    the RNG survey warns about."""
    u = trandom.uniform(key, w.shape, device=w.device)
    g = trandom.normal(key, w.shape, device=w.device)
    return w + u + g


def key_dropped_in_branch(key, w, flag):
    """A key consumed on one side of a flag and ignored on the other:
    whether the stream advances becomes data-dependent."""
    if flag:
        return w + trandom.uniform(key, w.shape, device=w.device)
    return w


#: ``copy_kernel`` as the TPU kernel of ``oversized_vmem`` holds its
#: operand: the whole array staged in shared memory, 4 bytes an element.
OVERSIZED_COPY = smem.KernelResources(
    smem.KERNELS["copy_kernel"].source, smem.KERNELS["copy_kernel"].index,
    smem.KERNELS["copy_kernel"].registers, 0, smem.KERNELS["copy_kernel"].grid,
    smem_per_element=4)


def oversized_vmem():
    """A whole-array copy over 8M f32 with its operand staged in shared
    memory, 32 MiB, past any block's budget: its declared footprint, priced
    and never launched."""
    return smem.price("copy_kernel", 1, _OVERSIZED_N, OVERSIZED_COPY)


def _inputs(device):
    dev = resolve_device(device)
    return trandom.PRNGKey(0), torch.zeros(_N, device=dev), torch.zeros(_N, 4, device=dev)


#: fixture name -> (audit of the fixture on a device, the pass expected to
#: fire).
FIXTURES = {
    "extra_launch": (
        lambda dev: audit_program("fixture:extra_launch",
                                  lambda: extra_launch(_inputs(dev)[1]), Contract(max_launches=1)),
        "launches"),
    "hbm_roundtrip": (
        lambda dev: audit_program("fixture:hbm_roundtrip",
                                  lambda: hbm_roundtrip(*_inputs(dev)[1:]),
                                  Contract(max_launches=1)),
        "census"),
    "reused_key": (
        lambda dev: audit_program("fixture:reused_key",
                                  lambda: reused_key(*_inputs(dev)[:2]), Contract(max_launches=0)),
        "rng"),
    "key_dropped_in_branch": (
        lambda dev: audit_program(
            "fixture:key_dropped_in_branch",
            lambda: key_dropped_in_branch(*_inputs(dev)[:2], True), Contract(max_launches=0),
            other_side=lambda: key_dropped_in_branch(*_inputs(dev)[:2], False)),
        "rng"),
    "oversized_vmem": (
        lambda dev: audit_program("fixture:oversized_vmem", None, Contract(max_launches=1),
                                  declared=[oversized_vmem()]),
        "smem"),
}


def leaky_telemetry(device="cuda"):
    """The pass-6 anti-fixture: a 'consumer' whose telemetry flag is NOT
    free.  Enabling it stages the weights through an extra kernel launch AND
    threads the record back into the estimate, so both halves of the
    neutrality check (launch parity, estimate parity) must fire.  Returns
    the recorded ``(off, on)`` runs."""
    device = resolve_device(device)

    def run(telemetry):
        key, z, _ = _inputs(device)
        w = z + trandom.uniform(key, z.shape, device=z.device)
        est = w.mean()
        if telemetry:
            record_ = copy_launch(w)  # an extra launch just for the record
            est = est + record_.amax()  # ...that leaks into the estimate
        return est.reshape(1)

    return record(lambda: run(False)), record(lambda: run(True))


def leaky_guard():
    """The pass-7 anti-fixture: a 'resampler' whose guard axis is NOT
    neutral: ``'flag'`` adds a torch call to the step, and ``'recover'``
    stages the state through an extra launch (``copy_launch``) AND emits
    NaN state on a degenerate bank, so all three §16 checks (flag identity,
    recover launch parity, degenerate recovery) must fire.  Returns the
    ``(off, flag, recover)`` objects, each with a ``step``."""
    from types import SimpleNamespace

    from repro_torch.obs.stats import StepStats

    def make(mode):
        def step(key, lw, p, thr):
            n = lw.shape[0]
            deg = ~torch.isfinite(lw.amax())
            ancestors = torch.arange(n, dtype=torch.int32, device=lw.device)
            p_out = p
            if mode == "flag_leak":
                p_out = p + 0.0  # a visible extra op
            if mode == "recover_leak":
                p_out = copy_launch(p)  # an extra launch just to recover
                p_out = torch.where(deg, torch.full_like(p_out, float("nan")), p_out)
            one = torch.ones((), device=lw.device)
            stats = StepStats(ess_norm=one, log_evidence_incr=one * 0.0, resampled=one,
                              max_weight=one / n,
                              survivors=torch.tensor(n, dtype=torch.int32),
                              degenerate=deg)
            return p_out, ancestors, stats

        return SimpleNamespace(step=step)

    return make("off"), make("flag_leak"), make("recover_leak")


def guard_selftest(device="cuda") -> list:
    """Pass 7 must flag the leaky fixture (all three violations) and pass a
    real cell; returns problems, empty when healthy."""
    from repro_torch.analysis.guards import audit_guard_cell, compare_guard_runs

    device = resolve_device(device)
    problems = []
    rep = compare_guard_runs("fixture:leaky_guard", *leaky_guard(), device=device)
    if rep["ok"]:
        problems.append("leaky_guard: expected §16 violations, got none")
    else:
        if rep["flag_program_match"]:
            problems.append("leaky_guard: expected the flag-identity check to fire")
        if rep["launches_recover"] == rep["launches_off"]:
            problems.append("leaky_guard: expected the recover launch-parity check to fire")
        if rep["degenerate_recovered"]:
            problems.append("leaky_guard: expected the degenerate-recovery check to fire")
    good = audit_guard_cell("megopolis", "cuda", device=device)
    if not good["ok"]:
        problems.append(f"guard pass flags a healthy cell: {good['violations']}")
    return problems


def telemetry_selftest(device="cuda") -> list:
    """Pass 6 must flag the leaky fixture (both violations) and pass a real
    cell; returns problems, empty when healthy."""
    from repro_torch.analysis.telemetry import audit_telemetry_cell, compare_runs

    device = resolve_device(device)
    problems = []
    rep = compare_runs("fixture:leaky_telemetry", *leaky_telemetry(device))
    if rep["ok"]:
        problems.append("leaky_telemetry: expected neutrality violations, got none")
    else:
        if rep["launches_on"] == rep["launches_off"]:
            problems.append("leaky_telemetry: expected the launch-parity check to fire")
        if rep["estimates_match"]:
            problems.append("leaky_telemetry: expected the estimate-parity check to fire")
    good = audit_telemetry_cell("megopolis", device)
    if not good["ok"]:
        problems.append(f"telemetry pass flags a healthy cell: {good['violations']}")
    return problems


#: The substring of a violation that each pass writes.
PASS_MARKS = {"launches": "launches exceed", "census": "ancestor-roundtrip", "rng": "[rng:",
              "smem": "[smem:"}


def audit_fixtures(device="cuda"):
    """Audit every fixture; returns a generator of ``(name, expected_pass,
    CellReport)`` (``cuda`` without a card raises here, before the first)."""
    device = resolve_device(device)
    return ((name, expected, audit(device)) for name, (audit, expected) in FIXTURES.items())


def selftest(device="cuda") -> list:
    """Returns a list of problems; empty means every pass catches its
    fixture and nothing else fires."""
    device = resolve_device(device)
    problems = []
    for name, expected, rep in audit_fixtures(device):
        if rep.ok:
            problems.append(f"{name}: expected a {expected} violation, got none")
            continue
        matched = {p: any(mark in v for v in rep.violations) for p, mark in PASS_MARKS.items()}
        if not matched[expected]:
            problems.append(f"{name}: expected the {expected} pass to fire, got {rep.violations}")
        others = [k for k, hit in matched.items() if hit and k != expected]
        if others:
            problems.append(f"{name}: unexpected extra findings from {others}")
    problems.extend(telemetry_selftest(device))
    problems.extend(guard_selftest(device))
    return problems
