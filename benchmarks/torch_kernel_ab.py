"""A/B timing of builds of one of the port's CUDA sources on one card, at the
shapes of ``chip_smoke.py``'s phase 4.

    python benchmarks/torch_kernel_ab.py --module megopolis.megopolis \\
        --source parent=PATH/megopolis.cu [--source LABEL=PATH ...] [--sass DIR]

``--module`` names a wrapper module under ``repro_torch.kernels`` (its
``SOURCE`` is the source under test: ``megopolis.megopolis``,
``metropolis.metropolis``, ``metropolis.c1c2``, ``rejection.rejection``,
``prefix_sum.prefix_sum``, ``fixtures.fixtures``).  Every ``--source
LABEL=PATH`` is a build of that source with the same C interface (an
earlier commit's, or a variant of the current one), next to its own
headers; the current source is always built too, as ``new``.  Each is
compiled with ``kernels/build.py``'s ``nvcc`` flags into
``kernels/_build/ab/`` (its ``ptxas`` registers, shared memory and spills
are printed; with ``--sass`` its SASS is written to ``DIR/<label>.sass``)
and handed to the module in place of its own library.
Phase 4's inputs are captured as phase 4 captures them
(``chip_smoke.kernel_cases``), and its cases whose kernel comes from that
source are kept; the fixture kernels' are those of phase 3
(``chip_smoke.fixture_cases``: the contract checks' inputs and N = 2^23).
Every build's outputs are held bit for bit to the plain version, and then
each case's kernel is timed (``chip_smoke.kernel_ms``, the profiler's
kernel events) with every build in turns: in the order given, then
reversed (old, new, new, old for two); the one PyTorch call that computes
the same function (``chip_smoke.library_call``), where there is one, is
timed as phase 4 times it (``chip_smoke.time_ms``) before and after the
turns.  For ``metropolis.metropolis`` the random-read yardstick of phase 4
(``chip_smoke.gather_probe``) is printed before and after the cases.
Prints the card's name and power limit, one JSON line per case and one
summary line.  It needs one card; the launches here count nowhere.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
import sys
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def build(label: str, source: Path, sass_dir) -> ctypes.CDLL:
    """Compile one source into its own library and load it."""
    from repro_torch.kernels import build as kbuild

    out_dir = kbuild.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    target = out_dir / f"lib{source.stem}-{label}.so"
    nvcc = kbuild._nvcc()
    log = subprocess.run([nvcc, *kbuild.NVCC_FLAGS, "-o", str(target), str(source)],
                         capture_output=True, text=True, check=False)
    if log.returncode != 0:
        raise SystemExit(f"nvcc failed on {source}:\n{log.stdout}{log.stderr}")
    for line in (log.stdout + log.stderr).splitlines():
        if any(s in line for s in ("entry function", "registers", "spill")):
            print(f"ptxas {label}: {line.strip()}")
    if sass_dir is not None:
        sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(target)],
                              capture_output=True, text=True, check=True).stdout
        Path(sass_dir).mkdir(parents=True, exist_ok=True)
        (Path(sass_dir) / f"{label}.sass").write_text(sass)
    return ctypes.CDLL(str(target))


def same(got, want, kind) -> bool:
    """Ancestors (or the CDF) and state bit for bit; for a step also the same
    triggers (its stats are fixed-order sums, held in ``chip_smoke.py``)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    ok = all(torch.equal(g.reshape(w.shape), w) for g, w in zip(got[:2], want[:2]))
    if kind == "step":
        ok = ok and torch.equal(got[2].reshape(want[2].shape)[:, 2], want[2][:, 2])
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--module", required=True,
                    help="wrapper module under repro_torch.kernels, e.g. megopolis.megopolis")
    ap.add_argument("--source", action="append", default=[], metavar="LABEL=PATH")
    ap.add_argument("--sass", help="write each build's SASS here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: no card (torch.cuda.is_available() is False)")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    mod = importlib.import_module(f"repro_torch.kernels.{args.module}")
    print(f"card: {cs.card_line()}", flush=True)
    sources = [s.split("=", 1) for s in args.source]
    sources.append(("new", str(ROOT / "src/repro_torch/kernels" / mod.SOURCE)))
    libs = {label: build(label, Path(path).resolve(), args.sass) for label, path in sources}
    labels = list(libs)
    probe = mod.SOURCE == cs.SOURCES["metropolis"]

    if mod.SOURCE == cs.SOURCES["fixtures"]:
        from repro_torch.analysis import fixtures as afix

        cases = cs.fixture_cases(torch.device("cuda"), mod, afix)
    else:
        # chip_smoke.py's defaults: the shapes of its phase 4.
        run = types.SimpleNamespace(particles=1 << 20, steps=100, bank=16, bank_steps=100,
                                    runs=64, seed=0)
        ctx = cs.setup(run)
        cases = [c for c in cs.kernel_cases(run, ctx.dev, ctx.families, ctx.model, ctx.fam,
                                            ctx.obs, ctx.bank_obs, ctx.thetas, ctx.k_run,
                                            ctx.k_quality)
                 if cs.SOURCES[c[4]] == mod.SOURCE]
    if not cases:
        raise SystemExit(f"torch_kernel_ab: phase 4 has no case of {mod.SOURCE}")
    if probe:
        cs.gather_probe(0, torch.device("cuda"))
    # The module loads its library through its own ``load``: hand it a build.
    real_load = mod.load
    summary = {}
    try:
        for name, wrapper, kargs, plain, family, kind, rows, iters in cases:
            want = plain()
            for label in labels:
                mod.load = lambda source, lib=libs[label]: lib
                if not same(wrapper(*kargs), want, kind):
                    raise SystemExit(f"{name}: build {label} differs from the plain version")
            n = kargs[0].shape[-1]
            reps = 20 if rows * n * iters < 2e9 else 4
            kernel = cs.kernel_name(family, kind, kargs)
            library = cs.library_call(kind, kargs)
            library_ms = [] if library is None else [cs.time_ms(library, reps)]
            times = {label: [] for label in labels}
            for label in labels + labels[::-1]:
                mod.load = lambda source, lib=libs[label]: lib
                times[label].append(cs.kernel_ms(lambda: wrapper(*kargs), kernel, reps))
            if library is not None:
                library_ms.append(cs.time_ms(library, reps))
            mean = {label: sum(t) / len(t) for label, t in times.items()}
            if library_ms:
                mean["library"] = sum(library_ms) / len(library_ms)
            summary[name] = mean
            print(f"ab {name}: " + json.dumps({"kernel": kernel, "rows": rows, "n": n,
                                               "iters": iters, "ms": times,
                                               "library_ms": library_ms or None,
                                               "mean_ms": mean}), flush=True)
    finally:
        mod.load = real_load
    if probe:
        cs.gather_probe(0, torch.device("cuda"))
    print(f"ab summary: {json.dumps(summary)}")
    print(f"card: {cs.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
