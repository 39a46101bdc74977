"""Aggregate report of the contract checks (DESIGN.md §13), after
``repro.analysis.report``.

One call produces the whole machine-readable audit: the family x backend x
entry matrix, the largest-shape pricing, the filter's consumer contracts
and the 'auto' reference paths' RNG, telemetry neutrality (pass 6), guard
neutrality (pass 7) and the §2.4 transaction table.  The CLI
(``python -m repro_torch.analysis``) serialises exactly this object.
"""

from __future__ import annotations

from repro_torch import resolve_device
from repro_torch.analysis import consumers as consumers_mod
from repro_torch.analysis import contracts as contracts_mod
from repro_torch.analysis import guards as guards_mod
from repro_torch.analysis import telemetry as telemetry_mod
from repro_torch.core.transactions import MEGOPOLIS_EXACT, measured_transaction_stats
from repro_torch.kernels.common import plane_itemsize

#: Families priced by the §2.4 transaction model (the iterate-and-compare
#: families the paper counts; prefix-sum and rejection have no
#: comparison-index stream to price).
TRANSACTION_FAMILIES = ("megopolis", "metropolis", "metropolis_c1", "metropolis_c2")


def transaction_report(*, n: int = 4096, num_iters: int = 32, word_bytes: int = 4) -> dict:
    """Measured vs declared §2.4 transactions per warp-iteration; each
    family entry carries ``ok`` (measured max within the declared bound;
    Megopolis additionally max == mean == the exact coalesced count, 4 at
    f32 words)."""
    out = {}
    exact = (MEGOPOLIS_EXACT * word_bytes) // 4
    for name in TRANSACTION_FAMILIES:
        stats = measured_transaction_stats(name, n=n, num_iters=num_iters,
                                           word_bytes=word_bytes)
        ok = stats["max"] <= stats["bound"]
        if name == "megopolis":
            ok = ok and stats["max"] == exact and stats["mean"] == float(exact)
        out[name] = {**stats, "ok": ok}
    return out


def build_report(*, families=None, entries=None, device="cuda", consumers: bool = True,
                 large_n: bool = True, transactions: bool = True, telemetry: bool = True,
                 resilience: bool = True, around=None, plane_dtypes=("float32",),
                 backends=None) -> dict:
    """Run every audit and return one JSON-serialisable report.

    ``report["ok"]`` is the single bit the CLI exits on: every cell within
    its launch budget with no round trip and no unwaived RNG or smem
    finding, every consumer likewise and the 'auto' reference paths free of
    unwaived RNG findings, every kernel within the card's limits at its
    largest admitted shapes, telemetry free (pass 6), the guards free
    (pass 7), and every measured transaction count within its declared §2.4
    bound.  ``backends`` (default both) is the matrix's and pass 7's
    backend axis.
    ``around(recording)`` is entered around each recorded run.  ``device``
    follows the package's device rule: ``cuda`` needs a card.
    ``plane_dtypes`` spans the DESIGN.md §14 compression axis: compressed
    cells (``contracts.audit_matrix``) against the same launch budgets, and
    the transaction table re-priced at 2-byte words
    (``transactions@bfloat16``)."""
    device = resolve_device(device)
    matrix = [rep.as_dict() for rep in contracts_mod.audit_matrix(
        families, entries, device, around, plane_dtypes, backends)]
    report: dict = {
        "device": str(device),
        "matrix": matrix,
        "matrix_cells": len(matrix),
        "matrix_violations": [c for c in matrix if not c["ok"]],
    }
    if large_n:
        big = [rep.as_dict() for rep in contracts_mod.audit_large_n()]
        report["large_n"] = big
        report["large_n_violations"] = [c for c in big if not c["ok"]]
    if consumers:
        cons = [rep.as_dict() for rep in consumers_mod.audit_consumers(device=device,
                                                                        around=around)]
        auto = [{"cell": cell, "ok": not kept, "findings": [f.as_dict() for f in kept],
                 "waived": waived}
                for cell, kept, waived in consumers_mod.auto_reference_rng(device=device)]
        report["consumers"] = cons
        report["consumer_violations"] = [c for c in cons if not c["ok"]]
        report["auto_reference_rng"] = auto
        report["auto_reference_violations"] = [a for a in auto if not a["ok"]]
    if telemetry:
        tel = list(telemetry_mod.audit_telemetry(families, device, around))
        report["telemetry"] = tel
        report["telemetry_violations"] = [c for c in tel if not c["ok"]]
    if resilience:
        res = list(guards_mod.audit_guards(families, backends, plane_dtypes, device, around))
        report["resilience"] = res
        report["resilience_violations"] = [c for c in res if not c["ok"]]
    if transactions:
        tx = transaction_report()
        report["transactions"] = tx
        report["transaction_violations"] = {k: v for k, v in tx.items() if not v["ok"]}
        for dtype in plane_dtypes:
            if dtype == "float32":
                continue
            txc = transaction_report(word_bytes=plane_itemsize(dtype))
            report[f"transactions@{dtype}"] = txc
            report["transaction_violations"].update(
                {f"{k}@{dtype}": v for k, v in txc.items() if not v["ok"]})
    report["ok"] = not (
        report["matrix_violations"]
        or report.get("large_n_violations")
        or report.get("consumer_violations")
        or report.get("auto_reference_violations")
        or report.get("telemetry_violations")
        or report.get("resilience_violations")
        or report.get("transaction_violations")
    )
    return report


def summarise(report: dict) -> str:
    """Human-readable digest of ``build_report``'s output."""
    lines = [f"matrix on {report['device']}: {report['matrix_cells']} cells, "
             f"{len(report['matrix_violations'])} violation(s)"]
    if "large_n" in report:
        lines.append(f"largest-shape footprints: {len(report['large_n'])} cells, "
                     f"{len(report['large_n_violations'])} violation(s)")
    if "consumers" in report:
        lines.append(f"consumers: {len(report['consumers'])} programs, "
                     f"{len(report['consumer_violations'])} violation(s); auto-reference rng: "
                     f"{len(report['auto_reference_violations'])} violation(s)")
        waived = sum(len(c["waived"]) for c in report["consumers"] + report["matrix"]
                     + report["auto_reference_rng"])
        if waived:
            lines.append(f"waivers applied: {waived}")
    if "telemetry" in report:
        lines.append(f"telemetry neutrality: {len(report['telemetry'])} cells, "
                     f"{len(report['telemetry_violations'])} violation(s)")
    if "resilience" in report:
        lines.append(f"guard neutrality: {len(report['resilience'])} cells, "
                     f"{len(report['resilience_violations'])} violation(s)")
    for section in [k for k in report if k.startswith("transactions")]:
        parts = ", ".join(f"{k}: max {v['max']}/bound {v['bound']}"
                          for k, v in report[section].items())
        lines.append(f"{section} per warp-iteration: {parts}")
    for section in ("matrix_violations", "large_n_violations", "consumer_violations",
                    "telemetry_violations", "resilience_violations"):
        for cell in report.get(section, []):
            for v in cell["violations"]:
                lines.append(f"  VIOLATION {cell['cell']}: {v}")
    for a in report.get("auto_reference_violations", []):
        for f in a["findings"]:
            lines.append(f"  VIOLATION {a['cell']}: [{f['pass_name']}:{f['code']}] {f['detail']}")
    for k, v in report.get("transaction_violations", {}).items():
        lines.append(f"  VIOLATION transactions/{k}: max {v['max']} > bound {v['bound']}")
    lines.append("OK" if report["ok"] else "FAILED")
    return "\n".join(lines)
