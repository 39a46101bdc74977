"""Per-cell contracts and the run-and-audit driver (DESIGN.md §13), after
``repro.analysis.contracts``.

A *cell* is one ``(family, entry)`` pair of ``core.spec.contract_cells``;
its contract bundles the declared invariants:

  * ``max_launches``: ``core.spec.launch_budget`` (the §12 fused step is 1
    for EVERY family);
  * ``allow_tainted_gather``: the ancestors-through-device-memory round
    trip is forbidden everywhere in the resampler matrix (the §11 rule);
  * RNG discipline, always on; a deliberate deviation carries an explicit
    ``Waiver`` with the reason in the report.

The JAX auditor traces each cell to a jaxpr; the port runs it once, at the
JAX auditor's geometry, under a recorder (``record``): the launch census,
the taint pass and the key log watch the run, and the smem pass prices each
launch it made.  On CUDA tensors the cells run the port's kernels; on CPU
tensors their plain versions.  JAX's host-level ``lax.cond`` count has no
eager counterpart: a branch in Python is not a primitive of a program.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import random as trandom
from repro_torch import resolve_device
from repro_torch.analysis import rng, smem, walker
from repro_torch.analysis.walker import Finding
from repro_torch.core.resamplers.batched import split_batch_keys
from repro_torch.core.spec import ENTRY_POINTS, contract_cells, family_spec, launch_budget
from repro_torch.kernels.common import observe_launches

# Audit geometry, the JAX auditor's: two tiles of particles, a 3-row bank, a
# 4-component state.
AUDIT_N = 2048
AUDIT_BATCH = 3
AUDIT_STATE_DIM = 4
AUDIT_NUM_ITERS = 16
AUDIT_MAX_ITERS = 64
AUDIT_THRESHOLD = 0.5


@dataclasses.dataclass(frozen=True)
class Waiver:
    """An explicitly waived finding: ``code`` + a substring of the detail,
    with the reason recorded in the report."""

    code: str
    match: str
    reason: str

    def covers(self, finding: Finding) -> bool:
        return finding.code == self.code and (
            self.match in finding.detail or self.match in finding.where
        )


@dataclasses.dataclass(frozen=True)
class Contract:
    """Declared invariants for one audited program."""

    max_launches: int
    allow_tainted_gather: bool = False
    waivers: tuple = ()


@dataclasses.dataclass
class Recording:
    """What one recorded run did: its kernel launches, the round trips the
    taint pass found and the keys it consumed."""

    launches: list
    roundtrips: list
    keys: rng.KeyLog

    @property
    def census(self):
        return walker.launch_census(self.launches)


def record(program: Callable, *, taint: bool = True, around=None):
    """Run ``program()`` once under the recorders; returns ``(its result,
    Recording)``.  ``around(recording)``, if given, is a context manager
    entered around the run (``chip_smoke.py`` profiles the card there)."""
    mode = walker.Taint() if taint else None
    log, keys = walker.LaunchLog(mode), rng.KeyLog()
    rec = Recording(log.launches, [] if mode is None else mode.findings, keys)
    with contextlib.ExitStack() as stack:
        stack.enter_context(observe_launches(log))
        stack.enter_context(trandom.observe_keys(keys))
        if around is not None:
            stack.enter_context(around(rec))
        if mode is not None:
            stack.enter_context(mode)
        out = program()
    return out, rec


@dataclasses.dataclass
class CellReport:
    """Audit result for one program against its contract."""

    cell: str
    launches: int
    max_launches: int
    census: dict
    tainted_gathers: int
    rng_findings: list
    smem_over: list
    footprints: list
    waived: list
    violations: list

    @property
    def ok(self) -> bool:
        return not self.violations

    def as_dict(self):
        return {
            "cell": self.cell,
            "ok": self.ok,
            "launches": self.launches,
            "max_launches": self.max_launches,
            "census": dict(self.census),
            "tainted_gathers": self.tainted_gathers,
            "rng_findings": [f.as_dict() for f in self.rng_findings],
            "smem_over": [f.as_dict() for f in self.smem_over],
            "smem_bytes": [fp.smem for fp in self.footprints],
            "waived": self.waived,
            "violations": self.violations,
        }


def audit_program(cell: str, program: Optional[Callable], contract: Contract, *,
                  other_side: Optional[Callable] = None, declared=(), around=None
                  ) -> CellReport:
    """Run ``program`` once under the recorders (the counterpart of JAX's
    ``audit_jaxpr``) and grade what it did against its contract.
    ``other_side`` is the same program on the other side of its flag: its
    keys must be consumed alike (branch-drop).  ``declared`` are footprints
    of launches that are priced and never made (``program`` may then be
    None).  ``around`` is entered around each run (``record``), the other
    side's too."""
    if program is None:
        rec = Recording([], [], rng.KeyLog())
    else:
        rec = record(program, around=around)[1]
    rng_found = rng.rng_findings(rec.keys)
    if other_side is not None:
        other = record(other_side, taint=False, around=around)[1]
        rng_found += rng.branch_findings(rec.keys, other.keys)
    footprints = [smem.price(x.kernel, x.rows, x.n) for x in rec.launches] + list(declared)
    smem_over = smem.smem_findings(footprints)
    launches = walker.count_launches(rec.launches)

    waived, violations = [], []

    def grade(findings):
        kept = []
        for f in findings:
            waiver = next((w for w in contract.waivers if w.covers(f)), None)
            if waiver is not None:
                waived.append({"finding": f.as_dict(), "reason": waiver.reason})
            else:
                kept.append(f)
        return kept

    if launches > contract.max_launches:
        violations.append(
            f"{launches} kernel launches exceed the declared budget of {contract.max_launches}")
    roundtrips = grade(rec.roundtrips)
    if roundtrips and not contract.allow_tainted_gather:
        violations.extend(str(f) for f in roundtrips)
    rng_found = grade(rng_found)
    violations.extend(str(f) for f in rng_found)
    smem_over = grade(smem_over)
    violations.extend(str(f) for f in smem_over)

    return CellReport(cell=cell, launches=launches, max_launches=contract.max_launches,
                      census=rec.census, tainted_gathers=len(roundtrips),
                      rng_findings=rng_found, smem_over=smem_over, footprints=footprints,
                      waived=waived, violations=violations)


# ------------------------------------------------------------ matrix cells
def audit_args(n=AUDIT_N, batch=AUDIT_BATCH, d=AUDIT_STATE_DIM, device="cuda") -> dict:
    """The audit's inputs: the key and a key bank on the CPU (as the filter
    keeps them), uniform weights, zero log-weights (no row resamples) and
    ``lw_fire``/``lwb_fire`` (an eighth of the mass-bearing particles: every
    row resamples), zero particles, on ``device`` (the package's device
    rule: ``cuda`` needs a card)."""
    key = trandom.PRNGKey(0)
    dev = resolve_device(device)
    fire = torch.where(torch.arange(n, device=dev) < n // 8, 0.0, -20.0)
    return {
        "key": key,
        "keys": split_batch_keys(key, batch),
        "w": torch.full((n,), 1.0 / n, device=dev),
        "wb": torch.full((batch, n), 1.0 / n, device=dev),
        "lw": torch.zeros(n, device=dev),
        "lwb": torch.zeros(batch, n, device=dev),
        "lw_fire": fire,
        "lwb_fire": fire.expand(batch, n).contiguous(),
        "p": torch.zeros(n, d, device=dev),
        "pb": torch.zeros(batch, n, d, device=dev),
    }


def entry_callable(resampler, entry: str, args: dict, fire: bool = False) -> Callable:
    """A thunk running one entry point of a built resampler on the audit's
    inputs; for ``step``/``step_rows``, ``fire`` takes the log-weights that
    resample."""
    a, thr = args, AUDIT_THRESHOLD
    lw, lwb = (a["lw_fire"], a["lwb_fire"]) if fire else (a["lw"], a["lwb"])
    table = {
        "call": lambda: resampler(a["key"], a["w"]),
        "batch": lambda: resampler.batch(a["key"], a["wb"]),
        "batch_rows": lambda: resampler.batch_rows(a["keys"], a["wb"]),
        "apply": lambda: resampler.apply(a["key"], a["w"], a["p"]),
        "apply_batch": lambda: resampler.apply_batch(a["key"], a["wb"], a["pb"]),
        "apply_rows": lambda: resampler.apply_rows(a["keys"], a["wb"], a["pb"]),
        "step": lambda: resampler.step(a["key"], lw, a["p"], thr),
        "step_rows": lambda: resampler.step_rows(a["keys"], lwb, a["pb"], thr),
    }
    if entry not in table:
        raise KeyError(f"unknown entry point {entry!r}; choices: {ENTRY_POINTS}")
    return table[entry]


def cell_resampler(name: str):
    """The built resampler of one family at the audit's iteration counts."""
    return family_spec(name, num_iters=AUDIT_NUM_ITERS, max_iters=AUDIT_MAX_ITERS).build()


def cell_contract(name: str, entry: str) -> Contract:
    return Contract(max_launches=launch_budget(name, entry))


def audit_cell(name: str, entry: str, args: dict, around=None) -> CellReport:
    """Run and audit one matrix cell.  A step cell runs on log-weights that
    resample, and again on ones that do not: the key must be consumed alike
    (the §12 rule)."""
    r = cell_resampler(name)
    steps = entry in ("step", "step_rows")
    return audit_program(
        f"{name}/cuda/{entry}", entry_callable(r, entry, args, fire=steps),
        cell_contract(name, entry),
        other_side=entry_callable(r, entry, args) if steps else None, around=around)


def audit_matrix(families=None, entries=None, device="cuda", around=None):
    """Run and audit every requested matrix cell; returns a generator of
    CellReports.  One shared args dict, made before the first cell (so a
    device without a card raises here); cells are independent, so a
    failure in one family still reports every other cell."""
    args = audit_args(device=device)
    return (audit_cell(name, entry, args, around)
            for name, entry in contract_cells(families, entries))


def audit_large_n():
    """Price every kernel of the port at the largest shapes the wrappers
    admit, WITHOUT launching (the counterpart of JAX's
    ``audit_large_n_footprints``); yields CellReports."""
    for cell, footprints in smem.large_n_footprints():
        yield audit_program(cell, None, Contract(max_launches=0), declared=footprints)
