"""A/B timing of builds of one of the port's CUDA sources on one card, at the
shapes of ``chip_smoke.py``'s phase 4.

    python benchmarks/torch_kernel_ab.py --module megopolis.megopolis \\
        --source parent=TREE/src/repro_torch/kernels/megopolis/csrc/megopolis.cu \\
        [--source LABEL=PATH ...] [--unchecked LABEL=PATH ...] [--sass DIR]
        [--planes float32]

``--module`` names a wrapper module under ``repro_torch.kernels`` (its
``SOURCE`` is the source under test: ``megopolis.megopolis``,
``metropolis.metropolis``, ``metropolis.c1c2``, ``rejection.rejection``,
``prefix_sum.prefix_sum``, ``fixtures.fixtures``, ``reduce.reduce``).  Every ``--source
LABEL=PATH`` is a build of that source in another tree of the repo (an
earlier commit's ``src/repro_torch``, unpacked with ``git archive``, or a
copy of this one with an edit); the current source is always built too, as
``new``.  All are compiled at once, with ``kernels/build.py``'s ``nvcc``
flags, into ``kernels/_build/ab/`` (its ``ptxas`` registers, shared memory
and spills are printed; with ``--sass`` its SASS is written to
``DIR/<label>.sass``).  Each build runs under its own tree's wrapper
modules, imported apart from this tree's, so it gets the buffers and the C
interface its source expects: the module's ``load`` hands it the build,
and each wrapper takes the leading arguments of a case that it names (a
later tree's wrapper may add some at the end).
Phase 4's inputs are captured as phase 4 captures them
(``chip_smoke.kernel_cases``), for its cases whose kernel comes from that
source (with ``--planes``, those of the plane dtypes named: an older tree
may take a 2-byte plane into its float32 instance); the fixture kernels' are those of phase 3
(``chip_smoke.fixture_cases``: the contract checks' inputs and N = 2^23).
Every build's outputs are held bit for bit to the plain version (but an
``--unchecked`` build's: a copy cut short to time its phases, which returns
before its outputs are written; a build whose wrapper refuses a case's
inputs with ``ValueError``, as an older tree's refuses a plane dtype it
does not take, sits that case out), and then
each case's kernel is timed (``chip_smoke.kernel_ms``, the profiler's
events of the port's kernels, whatever a build names them) with every
build in turns: in the order given, then
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
import concurrent.futures
import ctypes
import functools
import importlib
import inspect
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


def tree_src(source: Path) -> Path:
    """The ``src`` directory of the tree a source lies in
    (``src/repro_torch/kernels/<family>/csrc/<file>.cu``)."""
    src = source.parents[4]
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise SystemExit(f"torch_kernel_ab: {source} is not in a tree's src/repro_torch/kernels")
    return src


def tree_modules(src: Path, names) -> dict:
    """The modules ``names`` (``repro_torch.…``) of the tree under ``src``,
    imported apart from this tree's, which stay in ``sys.modules``."""
    def ours():
        return [k for k in sys.modules if k.split(".")[0] == "repro_torch"]

    mine = {k: sys.modules.pop(k) for k in ours()}
    sys.path.insert(0, str(src))
    try:
        return {name: importlib.import_module(name) for name in names}
    finally:
        sys.path.remove(str(src))
        for k in ours():
            del sys.modules[k]
        sys.modules.update(mine)


def leading(fn, args: tuple) -> tuple:
    """The leading arguments of ``args`` that ``fn`` names."""
    params = inspect.signature(fn).parameters.values()
    return args[:sum(p.kind == p.POSITIONAL_OR_KEYWORD for p in params)]


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
    ap.add_argument("--unchecked", action="append", default=[], metavar="LABEL=PATH",
                    help="a build timed but not held to the plain version")
    ap.add_argument("--sass", help="write each build's SASS here")
    ap.add_argument("--planes", default=None, metavar="DTYPE[,DTYPE]",
                    help="keep the cases of these plane dtypes (a case named '<name>@bfloat16' "
                         "is of bfloat16, the others of float32); default every case")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: no card (torch.cuda.is_available() is False)")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    mod = importlib.import_module(f"repro_torch.kernels.{args.module}")
    print(f"card: {cs.card_line()}", flush=True)
    builds = [(label, Path(path).resolve()) for label, path in
              (s.split("=", 1) for s in args.source + args.unchecked)]
    unchecked = {s.split("=", 1)[0] for s in args.unchecked}
    builds.append(("new", ROOT / "src/repro_torch/kernels" / mod.SOURCE))
    srcs = {label: tree_src(source) for label, source in builds}
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        built = list(pool.map(lambda b: build(*b, args.sass), builds))
    libs = {b[0]: lib for b, lib in zip(builds, built)}
    labels = list(libs)
    probe = mod.SOURCE == cs.SOURCES["metropolis"]

    if mod.SOURCE == cs.SOURCES["fixtures"]:
        from repro_torch.analysis import fixtures as afix

        cases = cs.fixture_cases(torch.device("cuda"), mod, afix)
    else:
        # chip_smoke.py's defaults: the shapes of its phase 4.
        run = types.SimpleNamespace(particles=1 << 20, steps=100, bank=16, bank_steps=100,
                                    runs=64, seed=0, phase="kernels")
        ctx = cs.setup(run)
        cases = cs.kernel_cases(run, ctx.dev, ctx.families, ctx.model, ctx.fam, ctx.obs,
                                ctx.bank_obs, ctx.thetas, ctx.k_run, ctx.k_quality,
                                source=mod.SOURCE)
    if args.planes is not None:
        keep = set(args.planes.split(","))
        cases = [c for c in cases if (c[0].split("@")[1] if "@" in c[0] else "float32") in keep]
    if not cases:
        raise SystemExit(f"torch_kernel_ab: phase 4 has no case of {mod.SOURCE}")
    if probe:
        cs.gather_probe(0, torch.device("cuda"))
    # Each build's module and wrappers, from its own tree; the module loads
    # its library through its own ``load``: hand it the build.
    names = [mod.__name__] + sorted({c[1].__module__ for c in cases})
    here = {name: sys.modules[name] for name in names}
    trees = {label: here if src == ROOT / "src" else tree_modules(src, names)
             for label, src in srcs.items()}
    loads = {label: t[mod.__name__].load for label, t in trees.items()}
    for label, t in trees.items():
        t[mod.__name__].load = lambda source, lib=libs[label]: lib
    summary = {}
    try:
        for name, wrapper, kargs, plain, family, kind, rows, iters in cases:
            want = plain()
            calls = {}
            for label, t in trees.items():
                fn = getattr(t[wrapper.__module__], wrapper.__name__)
                call = functools.partial(fn, *leading(fn, kargs))
                try:
                    got = call()
                except ValueError as err:  # an older tree's wrapper refuses the inputs
                    print(f"ab {name}: build {label} refuses the inputs ({err})", flush=True)
                    continue
                calls[label] = call
                if label not in unchecked and not same(got, want, kind):
                    raise SystemExit(f"{name}: build {label} differs from the plain version")
            n = kargs[0].shape[-1]
            reps = 20 if rows * n * iters < 2e9 else 4
            kernel = wrapper.kernel_name(*kargs)
            library = cs.library_call(kind, kargs)
            library_ms = [] if library is None else [cs.time_ms(library, reps)]
            took = [label for label in labels if label in calls]
            times = {label: [] for label in took}
            for label in took + took[::-1]:
                # Every launch of a port kernel: the wrapper launches one, under
                # whichever name its build gives it.
                times[label].append(cs.kernel_ms(calls[label], "", reps))
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
        for label, t in trees.items():
            t[mod.__name__].load = loads[label]
    if probe:
        cs.gather_probe(0, torch.device("cuda"))
    print(f"ab summary: {json.dumps(summary)}")
    print(f"card: {cs.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
