"""CLI of the contract checks.

    python -m repro_torch.analysis --check [--device cuda|cpu] [--json PATH]
                                   [--families megopolis,...] [--entries call,...]
                                   [--backends cuda,reference]
                                   [--plane-dtypes float32,bfloat16,float16]
                                   [--no-consumers] [--no-large-n]
                                   [--no-transactions] [--no-telemetry]
                                   [--no-resilience]
    python -m repro_torch.analysis --selftest [--device cuda|cpu]

``--check`` exits non-zero on any unwaived violation; ``--selftest``
verifies every pass still catches its bad fixture.  ``--device`` defaults
to ``cuda``: the port's kernels on the card; ``cpu`` runs their plain
versions.
"""

from __future__ import annotations

import argparse
import json
import sys


def _csv(value):
    return tuple(v for v in value.split(",") if v) or None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Audit the resampler matrix against its contracts.",
    )
    ap.add_argument("--check", action="store_true",
                    help="run the full audit; non-zero exit on violation")
    ap.add_argument("--selftest", action="store_true",
                    help="verify each pass catches its bad fixture")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the port's kernels on the card (default); cpu: their plain "
                         "versions")
    ap.add_argument("--json", metavar="PATH",
                    help="write the full machine-readable report to PATH")
    ap.add_argument("--families", type=_csv, default=None,
                    help="comma-separated family names (default: all)")
    ap.add_argument("--entries", type=_csv, default=None,
                    help="comma-separated entry points (default: all)")
    ap.add_argument("--backends", type=_csv, default=None,
                    help="comma-separated backends of the matrix and pass 7 (default: "
                         "cuda,reference)")
    ap.add_argument("--plane-dtypes", type=_csv, default=None,
                    help="comma-separated plane dtypes of the §14 compression axis (default: "
                         "float32; at bfloat16 and float16 every cell again)")
    ap.add_argument("--no-consumers", action="store_true",
                    help="skip the consumer-program audits")
    ap.add_argument("--no-large-n", action="store_true",
                    help="skip the largest-shape footprint pricing")
    ap.add_argument("--no-transactions", action="store_true",
                    help="skip the §2.4 transaction pricing")
    ap.add_argument("--no-telemetry", action="store_true",
                    help="skip the §15 telemetry-neutrality pass")
    ap.add_argument("--no-resilience", action="store_true",
                    help="skip the §16 guard-neutrality pass (pass 7)")
    args = ap.parse_args(argv)

    if not (args.check or args.selftest):
        ap.print_help()
        return 2

    from repro_torch import resolve_device

    device = resolve_device(args.device)
    rc = 0
    if args.selftest:
        from repro_torch.analysis.fixtures import selftest

        problems = selftest(device)
        for p in problems:
            print(f"selftest: {p}", file=sys.stderr)
        print(f"selftest: {'OK' if not problems else 'FAILED'}")
        rc = max(rc, 1 if problems else 0)

    if args.check:
        from repro_torch.analysis.report import build_report, summarise

        report = build_report(
            families=args.families, entries=args.entries, device=device,
            consumers=not args.no_consumers, large_n=not args.no_large_n,
            transactions=not args.no_transactions, telemetry=not args.no_telemetry,
            resilience=not args.no_resilience, backends=args.backends,
            plane_dtypes=args.plane_dtypes or ("float32",),
        )
        if args.json:
            with open(args.json, "w") as fh:
                json.dump(report, fh, indent=2, sort_keys=True, default=str)
            print(f"report written to {args.json}")
        print(summarise(report))
        rc = max(rc, 0 if report["ok"] else 1)

    return rc


if __name__ == "__main__":
    sys.exit(main())
