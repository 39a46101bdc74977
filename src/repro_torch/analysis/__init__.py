"""The contract checks of the port (DESIGN.md §13), after ``repro.analysis``.

Runs every resampler entry point, and the particle filter that consumes
them, once at the JAX auditor's geometry under recorders, and checks the
counted invariants the port's speed argument rests on: launch budgets by
kernel name, no ancestor round trip through device memory, RNG discipline,
each launch's shared memory and registers on the card, the
paper's §2.4 transaction counts, telemetry neutrality (pass 6) and guard
neutrality (pass 7), on both backends.  CLI:
``python -m repro_torch.analysis --check``.
"""

from repro_torch.analysis.consumers import audit_consumers, auto_reference_rng
from repro_torch.analysis.contracts import (
    CellReport,
    Contract,
    Waiver,
    audit_matrix,
    audit_program,
    entry_callable,
    record,
)
from repro_torch.analysis.guards import audit_guards, compare_guard_runs
from repro_torch.analysis.report import build_report, summarise, transaction_report
from repro_torch.analysis.rng import branch_findings, rng_findings
from repro_torch.analysis.smem import large_n_footprints, price, smem_findings
from repro_torch.analysis.telemetry import audit_telemetry
from repro_torch.analysis.walker import Finding, count_launches, launch_census

__all__ = [
    "CellReport",
    "Contract",
    "Finding",
    "Waiver",
    "audit_consumers",
    "audit_guards",
    "audit_matrix",
    "audit_program",
    "audit_telemetry",
    "auto_reference_rng",
    "branch_findings",
    "build_report",
    "compare_guard_runs",
    "count_launches",
    "entry_callable",
    "large_n_footprints",
    "launch_census",
    "price",
    "record",
    "rng_findings",
    "smem_findings",
    "summarise",
    "transaction_report",
]
