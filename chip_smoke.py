"""Chip smoke of the PyTorch + CUDA port: drive the resampler paths on one
NVIDIA card and hold every CUDA kernel against its plain version.

    python3 chip_smoke.py            # full width: N = 2**20, B = 32, T = 100, S = 16, K = 64

Phases, in order (any failure exits non-zero; nothing is caught and passed
over, and there is no CPU fallback):

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA source of ``src/repro_torch`` with ``nvcc`` for sm_90a
   (one ``nvcc`` per source, started together) and print ``ptxas``'
   registers per kernel;
3. in a process of its own (``--phase checks``: ``torch.profiler`` loses
   kernel records in a process that has run for minutes, and on an H100
   lost none in a new one), the contract checks
   (``python -m repro_torch.analysis``) on the card: the resource tables
   against the card's own attributes and limits; the 80 matrix cells of
   the ``cuda`` backend, the filter's consumers,
   the 'auto' reference paths' RNG, pass 6 and pass 7 (the guards) for all
   ten families (``--check``; the ``reference`` cells, which launch no
   port kernel, run in the CPU tests: a cut, printed), each recorded run's
   census, both sides of a step cell's flag, held to the profiler's count
   of the port's kernels in it, every ``cuda`` cell also at bfloat16 and at
   float16 planes (each
   dtype's cells in a run of their own), each launching what its float32
   cell launches; every kernel within the
   card's shared memory and registers at its largest admitted shapes, and
   the oversized fixture refused with no launch; ``--selftest``; then the
   two fixture kernels (rows 30-31) against their plain versions on their
   inputs in ``--selftest`` and at 2^23 (and each into a view one element
   into its tensor), timed and bounded as in phase 4, once the guard and
   resilience phases (5 and 5b), started beside it, have ended;
4. in a process of its own (``--phase kernels``), for each kernel wrapper,
   on its inputs captured from a short full-width run of the entry point
   that calls it (for a step, the last captured call that resampled),
   compare the kernel with its plain version on the card, time both, and
   compute the kernel's bound (for rejection from the rounds this run's
   data needs, with the rounds of the lanes and of their warps); hold the
   wrappers of rows 1-29 also on those inputs narrowed to bfloat16 and to
   float16 planes as a compressed spec narrows them (their kernels' 2-byte
   instances; names ending ``@bfloat16``, ``@float16``; the prefix-sum
   CDFs and draws stay float32; the float16 ones held and not timed, a cut,
   printed); hold ``logsumexp_rows`` (the adaptive AIS schedule's row
   reduction, no TPU counterpart) on E3's ``[S, N]`` and ``[2·S, N]``
   inputs and on a single run's ``[1, N]`` and ``[2, N]`` bit for bit and
   time it beside ``torch.logsumexp``; hold and time row 5's kernel on SMC
   decoding's state (``megopolis_step@int32``: the last resampling call of
   a smoke-config decode at 1024 particles, its token buffer ``int32[32,
   1024]`` the state; ``decode_step_case``); time each
   bank step kernel at capped cooperative grids (blocks per SM); hold
   ``rejection`` where its cap binds (eq. (12) weights at y = 4, N
   particles, ``max_iters`` 64); the prefix-sum wrappers on Path A's
   inputs, on a bank and on one population (a bank of one row; the
   systematic and stratified searches on its captured weights), every
   kind of the step, and beside each scan, search and fixture kernel the
   one PyTorch call that computes it (``library_ms``); beside the
   Metropolis cases, the rate of random 4-byte reads from one row in L2
   that one plain PyTorch gather reaches (``gather_probe``);
5. in a process of its own (``--phase guard``, young for the profiler),
   started beside phase 3 (which waits for it to end before it times the
   fixture kernels; phase 4 runs after both, alone), drive Path D and the
   reference backend, each run with every kernel's launch count set to 0
   just before and read just after (and 5b, Path F, the same way beside
   them: ``--phase resilience``, ``path_f``: dispatch spans around the step
   kernel with the census unchanged, the fallback ladder, the chaos bank
   through every family at ``guard="recover"``, kill-and-resume of the
   filter and of AIS at full width, the distributed resampler on NCCL at
   world size 1):
   * Path D, the degeneracy guard (DESIGN.md §16): UNGM log-weights of a
     bank of S filters' first step at N particles, row 3 all -inf and row
     11 with one NaN, through every Path A family's ``step_rows`` at
     float32 and bfloat16 planes at ``guard`` 'off', 'recover' and 'flag':
     the recovered rows' stats and finite state, the clean rows bit for
     bit with 'off', the port-kernel census of 'off' held to the profiler,
     'flag' bit for bit with 'off' and one event, and the CUDA launches
     'recover' adds;
   * the reference backend (``backend="reference"``) of every family name:
     ``r(key, w)`` and ``r.batch(key, w_bank)`` at N = 2^18 on the card,
     bit for bit with the same calls on the CPU, timed beside the ``cuda``
     backend's;
6. in a process of its own (``--phase ais``), alone after phase 4 (its runs
   are timed), Path E, the AIS sampler (DESIGN.md §10, ``path_e``): banks of
   8 i.i.d. ``run_smc_sampler_bank`` rows (16 in the protocol: a cut,
   printed) at N particles, d = 2, T = 24,
   the geometric ladder and RWM, on ``isotropic_gaussian`` and
   ``gaussian_mixture``, for Megopolis, Metropolis, rejection and
   systematic: logZ against the analytic truth (every row inside
   ``tests/test_ais.py``'s gate), resamples, seconds (each run warmed up by
   a profiled run of its own, then timed without the profiler), the census
   and, from the profiled run, all CUDA launches and the device's busy
   share; each family's step wrapper held against its plain version on the
   [S, D, N] inputs of one call of its run; one row against its single call
   bit for bit; the adaptive ladder with MALA (and a bank of 4 whose row
   equals its single call bit for bit); Megopolis and systematic at bfloat16 planes; a
   small run on the card against the CPU and telemetry on and off;
6b. in a process of its own (``--phase decode``), alone after Path E (its
   runs are timed and profiled), Path G, SMC decoding (DESIGN.md §5,
   ``path_g``): ``serve_once`` of Qwen3-0.6B at its published width (28
   layers, vocab 151936) in float32, 1024 particles, 16 + 32 tokens, the
   Megopolis step kernel resampling them with the int32 token buffer as its
   state (G1: seconds, tokens a second, resamples, memory; one step launch
   a token); the same decode profiled, split into the model, the
   categorical draw, the step and the KV gather by separator kernels (G2);
   the step kernel bit for bit against its plain version on the last
   resampling call of the same decode run once more, untimed (G3); one prompt for every particle at near-greedy
   temperatures, every continuation equal (G4); the smoke config on the
   card against the CPU from the same params (G5);
7. drive the paths through the user's entry points, each run with every
   kernel's launch count set to 0 just before and read just after:
   * Path A, the particle filter (paper §7, Table 2, Fig. 9), once with
     each family: ``MegopolisSpec``, ``MetropolisSpec`` (Table 2's baseline
     column), ``MetropolisC1Spec`` and ``MetropolisC2Spec`` (Fig. 9's
     segment-local baselines), ``RejectionSpec(max_iters=1024)``
     (Murray's rejection, paper §1) and ``PrefixSumSpec`` of the kinds
     ``multinomial`` and ``improved_systematic`` (Table 2's unbiased
     columns) and ``residual``: ``run_filter`` in Alg. 6 and in
     conditional mode (ESS threshold 0.5), ``run_filter_bank`` (S
     scenarios) in both modes (every family at PATH_A_BANK_STEPS of the T bank
     steps, a cut printed on its own line), and ``run_filter_timed``; RMSE
     against ``simulate``'s truth, steps/s, the resample ratio and a
     ``StepStats`` summary, the families side by side, and the census of
     each run held
     to the entry's launch budget x steps, beside all CUDA launches of a
     conditional step; every family also at bfloat16 planes and Megopolis
     and Metropolis at float16 (``MegopolisSpec(plane_dtype="bfloat16")``
     and so on, families ``megopolis@bfloat16`` ... ``residual@bfloat16``,
     ``metropolis@float16``, their launches counted under
     ``<wrapper>@<dtype>``; ``PATH_PLANES``); for rejection and residual also
     ``r(key, w)``, ``r.batch(key, w_bank)`` and ``r.batch_rows(keys,
     w_bank)`` on weights captured from their Alg. 6 runs (no step calls
     them), and the spread of rejection's kernel time and of sup w /
     mean w over the steps of one Alg. 6 run;
   * Path B, the quality and speed study (paper §6.3, Fig. 6): for each y
     of 0, 2 and 4, Gaussian weights at N particles, B from eq. (3) in
     closed form, K Monte Carlo resamples in one ``batch_rows`` launch,
     then MSE/N and the bias share (eq. 21), and the time of one
     ``r(key, w)`` and one ``r.batch(key, w_bank)``, for every family of
     Fig. 6's method set (rejection is not in it), and each at bfloat16
     planes, Megopolis and Metropolis at float16 too; and Method 2 (paper
     eq. 13): for each alpha of 0.5, 2, 3, 10 and 50, Gamma(alpha, 1)
     weights drawn on the card by ``gamma_weights`` (the share of samples
     bit-equal to the same draw on the CPU printed), B from eq. (3), the
     same K resamples and figures for the four float32 families;
   * Path C, Fig. 8's study (paper §6.5): for N of 2^14, 2^18 and 2^22
     and each y of 0, 2 and 4, Megopolis (B from eq. (3)) against the
     multinomial and improved systematic kinds, each also at bfloat16
     planes: K Monte Carlo resamples in
     one ``batch_rows`` launch per stage, MSE/N, the bias share, and the
     time of one ``r(key, w)``;
   * small runs of both paths on the card against the same runs on the CPU,
     and for the prefix-sum kinds each step of an Alg. 6 run on the CPU
     replayed on the card bit for bit;
8. print the card line, one JSON line of kernels (all 31 rows, rows 1-29
   also at each 2-byte plane word), then a last JSON line naming the
   device.

Run it from the root of a checkout; it needs one card.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
#: The card's memory rate and its rate of 32-bit arithmetic outside the
#: tensor cores (H100 SXM data sheet, at the 700 W limit).  The data sheet's
#: 67e12 counts a fused multiply-add as two operations (128 FP32 lanes per SM
#: per clock); the sweeps are mostly 32-bit integer work (IMAD, shifts, XOR,
#: LOP3), which issues at 64 lanes per SM per clock, a quarter to a half of
#: that count.  So the operations bound below is 2-4x below what the integer
#: work can reach: a floor, not an estimate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: The card's L2 (H100 SXM): the Metropolis weights are read at random from it.
L2_BYTES = 50e6
#: Bytes of one L2 sector: each random 4-byte read of w[j] moves one.
L2_SECTOR = 32
#: The random-read yardstick (``gather_probe``): indices, over one row of N.
PROBE_INDICES = 1 << 26
PROBE_N = 1 << 20
#: Iterations on Path A, the middle of the paper's B sweep (§7).
ITERS = 32
#: The compressed plane dtypes of Paths A and B (DESIGN.md §14), beside
#: float32, and the families run at each (Path B: those of Fig. 6's set;
#: float16 of the other families is held in phases 3 and 4).
PATH_PLANES = {
    "bfloat16": ("megopolis", "metropolis", "metropolis_c1", "metropolis_c2", "rejection",
                 "multinomial", "improved_systematic", "residual"),
    "float16": ("megopolis", "metropolis"),
}
#: Path B's weight sequences: y of eq. (12), a third of GAUSSIAN_Y_GRID.
PATH_B_YS = (0.0, 2.0, 4.0)
#: Time steps of the short runs whose resampler inputs phase 4 captures.
CAPTURE_STEPS = 5
#: Bank steps of every family's Path A bank runs: cut from T = 100 to keep
#: the whole run, Paths D, E, F and G and Method 2 included, near 600 s of
#: the 1200 s limit.  The cut is printed, and after Path A what it saves:
#: the 36 bank runs (18 families, two modes) took 1.2-1.3 s a bank step,
#: so 100 steps would add about 90 s to a whole run of 578 s at 25 steps
#: before Path G (about 55 s with its process) and 584-675 s with it.
PATH_A_BANK_STEPS = 25
#: The ESS threshold of the conditional runs (Path A's and phase 4's).
THR = 0.5
#: 32-bit operations per (particle, iteration) of each family's sweep,
#: counted from the sources.  Megopolis: index map 6, murmur3 finalizer 8,
#: lane-hash xor 1, shift, convert and scale 3, the product and the compare
#: 2.  Metropolis: two murmur3 finalizers 16, two lane-hash xors 2, the
#: unsigned modulo by N 1 (counted as one operation; it compiles to a dozen
#: or more instructions, so this too is a floor), shift, convert and scale
#: 3, the product and the compare 2.  C1/C2: as Metropolis, with the mask
#: (mod 1024) and the add of the partition's base in place of the modulo.
#: Rejection: a round is a Metropolis iteration (24), counted per realised
#: round, not per ``max_iters``.
SWEEP_OPS = {"megopolis": 20, "metropolis": 24, "metropolis_c1": 25, "metropolis_c2": 25,
             "rejection": 24}
#: Rejection on Path A: the JAX package's default cap.
REJECTION_MAX_ITERS = 1024
#: The cap of phase 4's extra rejection case on eq. (12) weights at y = 4,
#: low enough that it binds for a share of the lanes.
REJECTION_CAP_CASE_ITERS = 64
#: The prefix-sum kinds on Path A: Table 2's unbiased columns
#: (``benchmarks/table2_e2e_pf.py``), and residual, the one kind that reaches
#: the residual select and the residual step.
PATH_A_PREFIX_KINDS = ("multinomial", "improved_systematic", "residual")
#: Path C (Fig. 8, ``benchmarks/fig8_prefix_sum.py``): its methods (the
#: prefix-sum kinds also at bfloat16 planes) and N.
PATH_C_METHODS = ("megopolis", "multinomial", "improved_systematic", "multinomial@bfloat16",
                  "improved_systematic@bfloat16")
PATH_C_NS = (1 << 14, 1 << 18, 1 << 22)
#: Path C's key: fold_in(k_quality, PATH_C_KEY).
PATH_C_KEY = 8
#: 32-bit operations per element of the prefix-sum kernels, counted from the
#: source: the scan's adds (one in the row of 16, the offsets of the two
#: levels, the carry); a bisection step (the midpoint's subtract, shift and
#: add, the compare, two selects); the step's draw (convert, add, multiply)
#: and residual's split of a weight (divide, multiply, floor, subtract, sum).
SCAN_OPS = 3
BISECT_OPS = 6
DRAW_OPS = 3
#: 32-bit operations per element of the row reduction: its max, the
#: subtract, the exp (counted as one) and the add.
LSE_OPS = 4
RESIDUAL_SPLIT_OPS = 5
#: Lanes of a warp: a warp runs as many rounds as its slowest lane.
WARP = 32
#: Per particle of the step prelude: max, subtract, exp (about 10), the
#: flushes, three sums, a square and a max.
PRELUDE_OPS = 20
#: Step stats: ess_norm and max_weight are ratios of f32 sums taken in
#: another order than torch.sum; relative error per sum of N = 2**20 terms is
#: well below 1e-5.  incr = m + log(Σw) - log N, absolute.
STATS_RTOL = 1e-5
INCR_ATOL = 1e-5
#: Card time phase 4 gives each plain version's timing after its comparison
#: call, in ms.
PLAIN_BUDGET_MS = 250.0
#: Path D (the degeneracy guard, DESIGN.md §16): the bank's rows made
#: degenerate (row 3 all -inf, row 11 one NaN; taken modulo a smaller bank)
#: and the plane dtypes its families run at.
PATH_D_ROWS = (3, 11)
PATH_D_PLANES = ("float32", "bfloat16")
#: The reference backend on the card: its particle count, bank rows, the
#: eq. (12) y of its weights and its iteration counts (B, rejection's cap:
#: the CPU half of the comparison, plain torch ops at 2^18, sets the time).
REFERENCE_N = 1 << 18
REFERENCE_ROWS = 2
REFERENCE_Y = 2.0
REFERENCE_ITERS = 8
REFERENCE_MAX_ITERS = 32
#: Whole-run agreement of a small filter on the card and on the CPU: the
#: noise differs by a few ULP (log1p, sqrt), which flips a rare accept; each
#: flip moves an estimate by at most the particle range over N.
SMALL_RUN_ATOL = 0.05
#: Path E, the AIS sampler (DESIGN.md §10), in ``benchmarks/ais_bench.py
#: --full``'s protocol (T = 24 temperatures, the geometric ladder, RWM with 2
#: move steps, B = 16, the four families of ``tests/test_ais.py``) at Path
#: A's N = 2^20, d = 2; rejection at Path A's ``max_iters``.
AIS_FAMILIES = ("megopolis", "metropolis", "rejection", "systematic")
AIS_TEMPS = 24
AIS_ITERS = 16
#: E1's bank, the Monte Carlo repeats (16 in the protocol), cut to 8 rows to
#: keep the whole run near 600 s (printed); E3's bank; the rows E2 and E3
#: hold to their single calls.
AIS_BANK_FULL = 16
AIS_BANK = 8
AIS_E3_BANK = 4
AIS_E2_ROW = 5
AIS_E3_ROW = 1
#: E5, the card against the CPU: N particles and temperatures.
AIS_SMALL_N = 4096
AIS_SMALL_TEMPS = 8
#: The plane dtype and families of E4 (``test_ais.py``'s bfloat16 gate).
AIS_PLANE = "bfloat16"
AIS_PLANE_FAMILIES = ("megopolis", "systematic")
#: Path E's key: ``fold_in(k_quality, AIS_KEY)``.
AIS_KEY = 25


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean time of ``fn()`` on the card, by CUDA events over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_events(prof) -> list:
    """The kernel events of a ``torch.profiler`` run in the order they
    started: ``(start ns, name, µs)``, read from its raw records
    (``prof.events()`` first builds every event's tree in Python, about 1 s
    per 10^4 events).  Path E holds the two readers equal on one profile
    each run (``ais_readers``)."""
    cuda = torch.autograd.DeviceType.CUDA
    return sorted((e.start_ns(), e.name(), e.duration_ns() / 1e3)
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == cuda
                  and not getattr(e, "is_hidden_event", lambda: False)())


def device_kernels(prof) -> list:
    """The kernel events of a ``torch.profiler`` run: ``(name, µs)``."""
    return [(name, us) for _, name, us in device_events(prof)]


def kernel_instance(event: str):
    """The kernel's name with its template arguments (``copy_kernel``,
    ``prefix_step_rows_kernel<3>``) in a profiler event's name, or None for
    a kernel that is not a plain function (PyTorch's ``at::native::``)."""
    m = re.match(r"(?:void )?(\w+(?:<[^()]*>)?)\(", event)
    return None if m is None else m.group(1)


def is_kernel(event: str, kernel: str) -> bool:
    """True when a profiler event is a launch of ``kernel`` (a name, or the
    start of one: ``metropolis_c1c2_rows_kernel<1``; "" for any of the
    port's kernels, which are plain functions)."""
    inst = kernel_instance(event)
    return inst is not None and inst.startswith(kernel)


def kernel_ms(fn, kernel: str, reps: int = 20) -> float:
    """Mean device time of the CUDA kernel named ``kernel`` over at least
    ``reps`` launches, from the profiler's kernel events (CUDA events around
    the calls would also count the wrapper's host work).  The profiler
    drops kernel records, early in a session (seen on the card: 9 of 25, 19
    of 20 seen) and in a process that has run for minutes (1 of 60), so a
    profile makes ``3·reps`` calls, up to three profiles run until ``reps``
    launches are recorded, and every launch recorded is averaged;
    each is the same work on the same inputs.  The calls run back to back,
    so the weights are warm in L2, as the filter leaves them."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            for _ in range(3 * reps):
                fn()
            torch.cuda.synchronize()
        times += [us for name, us in device_kernels(prof) if is_kernel(name, kernel)]
        if len(times) >= reps:
            return sum(times) / len(times) / 1e3
    fail(f"profiler saw {len(times)} launches of {kernel} in three profiles of "
         f"{3 * reps} calls, fewer than {reps}")


def capture(module, name: str, run) -> tuple:
    """The arguments of one call of ``module.<name>`` made by ``run()``: the
    last call after which some row resampled (every call of an index-only or
    apply wrapper); if there is none, the last call.  These launches are not
    the main path's: its counts are set to 0 before each of its runs."""
    real = getattr(module, name)
    calls = []

    def record(*args):
        out = real(*args)
        step = isinstance(out, tuple) and len(out) == 3
        fired = not step or bool(out[2].reshape(-1, 4)[:, 2].any())
        calls.append((fired, tuple(a.clone() if torch.is_tensor(a) else a for a in args)))
        return out

    setattr(module, name, record)
    try:
        run()
    finally:
        setattr(module, name, real)
    if not calls:
        fail(f"{name} was not called while capturing its inputs")
    fired = [args for f, args in calls if f]
    return fired[-1] if fired else calls[-1][1]


def capture_weights(run, method: str) -> torch.Tensor:
    """The weights of the last call of the built resampler's ``method``
    (``apply`` or ``apply_rows``) that ``run()`` makes: an Alg. 6 filter
    calls it once a step, so these are its last step's, for every family
    alike."""
    from repro_torch.core.spec import Resampler

    real = getattr(Resampler, method)
    seen = []

    def record(self, key, w, particles):
        seen[:] = [w.clone()]
        return real(self, key, w, particles)

    setattr(Resampler, method, record)
    try:
        run()
    finally:
        setattr(Resampler, method, real)
    if not seen:
        fail(f"Resampler.{method} was not called while capturing its weights")
    return seen[0]


def summary(stats) -> dict:
    return {
        "ess_norm_mean": float(stats.ess_norm.float().mean()),
        "resampled_frac": float(stats.resampled.float().mean()),
        "max_weight_max": float(stats.max_weight.float().max()),
        "survivors_min": int(stats.survivors.min()),
        "degenerate_any": bool(stats.degenerate.any()),
    }


#: The phases that run in a process of their own, before the paths: each
#: relies on ``torch.profiler``'s kernel records, which a process that has
#: run for minutes loses (``kernel_ms``).
PHASES = ("checks", "kernels", "guard", "ais", "resilience", "decode")
PHASE_TIMEOUT_S = 600


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--particles", type=int, default=1 << 20)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--bank", type=int, default=16)
    ap.add_argument("--bank-steps", type=int, default=100)
    ap.add_argument("--runs", type=int, default=64, help="Path B's K Monte Carlo resamples")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase", choices=PHASES, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script measures the card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"{ROOT / 'src' / 'repro_torch'} not found: run from a checkout of the repo")
    sys.path.insert(0, str(ROOT / "src"))

    if args.phase is not None:
        ctx = setup(args)
        kernels = {"checks": checks_phase, "kernels": kernels_phase, "guard": guard_phase,
                   "ais": ais_phase, "resilience": resilience_phase,
                   "decode": decode_phase}[args.phase](ctx)
        print(json.dumps({"phase": args.phase, "path_launches": ctx.path_launches,
                          "results": ctx.results, "kernels": kernels}, default=float))
        return 0

    from repro_torch.kernels import build

    card = card_line()
    print(f"card: {card}", flush=True)

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {len(logs)} source(s) in {time.perf_counter() - t0:.1f} s")
    for src, log in logs.items():
        for line in log.splitlines():
            if any(s in line for s in ("entry function", "registers", "spill")):
                print(f"  {src}: {line.strip()}")

    # -- 3-6. the contract checks beside the guard; the kernels, AIS, decoding --
    phases = run_phases(argv)

    # -- 7. the paths ----------------------------------------------------------
    ctx = setup(args)
    for out in phases.values():
        for wname, c in out["path_launches"].items():
            ctx.path_launches[wname] = ctx.path_launches.get(wname, 0) + c
        ctx.results.update(out["results"])
    families, results, dev, n = ctx.families, ctx.results, ctx.dev, ctx.n
    model, fam, obs, k_run, drive = ctx.model, ctx.fam, ctx.obs, ctx.k_run, ctx.drive
    lap = time.perf_counter()

    def took(what):
        nonlocal lap
        print(f"time {what}: {time.perf_counter() - lap:.1f} s", flush=True)
        lap = time.perf_counter()

    for family, f in families.items():
        path_a(family, f, args, dev, model, fam, obs, ctx.truth, ctx.bank_obs, ctx.bank_truth,
               ctx.thetas, k_run, drive, results)
    took("path A")
    bank_s = [r["seconds"] for name, r in results.items() if name.startswith("run_filter_bank/")]
    bank_steps = min(args.bank_steps, PATH_A_BANK_STEPS)
    if bank_steps < args.bank_steps:
        per_step = sum(bank_s) / bank_steps
        print(f"cut run_filter_bank: {len(bank_s)} bank runs of {bank_steps} steps took "
              f"{sum(bank_s):.1f} s, {per_step:.3f} s a step; the {args.bank_steps - bank_steps} "
              f"steps cut would add about {per_step * (args.bank_steps - bank_steps):.0f} s",
              flush=True)
    for family in ("rejection", "residual"):
        path_a_index(family, families[family], args, dev, model, fam, obs, ctx.bank_obs,
                     ctx.thetas, k_run, drive, results)
    results["rejection_spread"] = rejection_spread(families["rejection"]["spec"], n, model,
                                                   obs, k_run, dev)
    for family, f in ctx.path_b_families.items():
        path_b(family, f, args, dev, ctx.k_quality, drive, results)
    took("path A's index entries, rejection's spread, path B")
    path_b_gamma(args, dev, ctx.k_quality, drive, results,
                 {name: f for name, f in ctx.path_b_families.items() if "plane" not in f})
    took("path B, Method 2")
    path_c(args, dev, ctx.trandom.fold_in(ctx.k_quality, PATH_C_KEY), drive, results,
           {"megopolis": (ctx.mk.megopolis_rows, ctx.mk.megopolis),
            "multinomial": ctx.prefix_index, "improved_systematic": ctx.prefix_index})
    took("path C")
    results["small_runs_card_vs_cpu"] = small_runs(families, obs, ctx.truth, k_run,
                                                   ctx.k_quality, dev)
    took("small runs")
    # The float32 families' (a compressed twin's host work is theirs).
    results["host_and_device_per_step"] = {
        family: step_costs(family, k_run, n, ITERS, dev, model, f["spec"], obs)
        for family, f in families.items() if "plane" not in f}
    took("step costs")
    for name, r in results.items():
        print(f"path {name}: {json.dumps(r, default=float)}", flush=True)
    path_a_census(args, families, results)
    for mode in ("run_filter/alg6", "run_filter/conditional", "run_filter_bank/alg6",
                 "run_filter_bank/conditional", "run_filter_timed/alg6"):
        side = {family: {k: results[f"{mode}/{family}"].get(k) for k in
                         ("steps_per_s", "rmse", "rmse_mean",
                          f"rmse_mean_first_{PATH_A_BANK_STEPS}", "resample_ratio")}
                for family in families}
        print(f"compare {mode}: {json.dumps(side)}")
    for y in PATH_B_YS:
        side = {family: {k: results[f"fig6/y={y}/{family}"][k] for k in
                         ("B", "mse_over_n", "bias_share", "single_ms", "batch_ms")}
                for family in ctx.path_b_families}
        print(f"compare fig6/y={y}: {json.dumps(side)}")
    from repro_torch.core.weightgen import GAMMA_ALPHA_GRID

    for alpha in GAMMA_ALPHA_GRID:
        side = {family: {k: results[f"fig6_gamma/alpha={alpha}/{family}"][k] for k in
                         ("B", "mse_over_n", "bias_share", "single_ms", "batch_ms")}
                for family in ctx.path_b_families if "@" not in family}
        side["weights"] = results[f"fig6_gamma/alpha={alpha}/weights"]
        print(f"compare fig6_gamma/alpha={alpha}: {json.dumps(side)}")
    for n_c in PATH_C_NS:
        for y in PATH_B_YS:
            side = {m: {k: results[f"fig8/n={n_c}/y={y}/{m}"][k] for k in
                        ("mse_over_n", "bias_share", "single_ms")} for m in PATH_C_METHODS}
            print(f"compare fig8/n={n_c}/y={y}: {json.dumps(side)}")

    # The launches reported are those of the main path's runs (phases 3 and
    # 5), not the ones made to compare and time.
    kernels = phases["kernels"]["kernels"] + phases["checks"]["kernels"]
    for entry in kernels:
        entry["launches"] = ctx.path_launches.get(entry["name"], 0)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


#: The environment variable naming the files (joined by ``os.pathsep``) whose
#: existence tells the checks phase that the phases run beside it have ended.
BESIDE_DONE_ENV = "CHIP_SMOKE_BESIDE_DONE"
#: The phases that run beside the checks phase, each in its own process.
BESIDE_CHECKS = ("guard", "resilience")


def phase_cmd(name: str, argv) -> list:
    return [sys.executable, str(Path(__file__).resolve()),
            *(sys.argv[1:] if argv is None else argv), "--phase", name]


def phase_result(name: str, returncode: int, stdout: str, seconds: float) -> dict:
    """A phase's output passed through and its last line, a JSON object with
    the counts of its ``drive`` runs and its ``kernels`` entries, returned.
    Any failure there fails here."""
    lines = stdout.splitlines()
    print("\n".join(lines[:-1] if returncode == 0 else lines), flush=True)
    if returncode != 0 or not lines:
        fail(f"phase {name} exited {returncode}")
    print(f"phase {name}: {seconds:.1f} s in its own process", flush=True)
    return json.loads(lines[-1])


def run_phases(argv) -> dict:
    """Run the phases of ``PHASES``, each in a new process (``--phase``),
    young, as the profiler needs it.  The guard and resilience phases run
    beside the checks phase, which waits for both to end before it times
    the fixture kernels; the kernels phase, which times every kernel, runs
    alone after them, the AIS phase (Path E, timed) alone after it and the
    decode phase (Path G, timed and profiled) alone after that.  Every
    process started here is waited for, or killed at its time limit."""
    with tempfile.TemporaryDirectory() as tmp:
        outs, procs, waiters, done, took = {}, {}, [], [], {}
        for name in BESIDE_CHECKS:
            outs[name] = open(Path(tmp) / f"{name}.out", "w+")
            procs[name] = subprocess.Popen(phase_cmd(name, argv), stdout=outs[name], text=True)
            done.append(Path(tmp) / f"{name}.done")

            def reap(name=name, flag=done[-1], t0=time.perf_counter()):
                try:
                    procs[name].wait(timeout=PHASE_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    procs[name].kill()
                    procs[name].wait()
                took[name] = time.perf_counter() - t0
                flag.touch()

            waiters.append(threading.Thread(target=reap))
            waiters[-1].start()
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(phase_cmd("checks", argv), stdout=subprocess.PIPE,
                                  text=True, timeout=PHASE_TIMEOUT_S,
                                  env=dict(os.environ, **{BESIDE_DONE_ENV: os.pathsep.join(
                                      str(d) for d in done)}))
        finally:
            for waiter in waiters:
                waiter.join()
        phases = {"checks": phase_result("checks", proc.returncode, proc.stdout,
                                         time.perf_counter() - t0)}
        for name in BESIDE_CHECKS:
            with outs[name] as out:
                out.seek(0)
                phases[name] = phase_result(name, procs[name].returncode, out.read(), took[name])
    for name in ("kernels", "ais", "decode"):
        t0 = time.perf_counter()
        proc = subprocess.run(phase_cmd(name, argv), stdout=subprocess.PIPE, text=True,
                              timeout=PHASE_TIMEOUT_S)
        phases[name] = phase_result(name, proc.returncode, proc.stdout, time.perf_counter() - t0)
    return phases


def wait_for_beside():
    """In the checks phase: wait until the phases beside it have ended (the
    files named by ``BESIDE_DONE_ENV`` exist), so that nothing else runs on
    the card while the fixture kernels are timed."""
    paths = [p for p in os.environ.get(BESIDE_DONE_ENV, "").split(os.pathsep) if p]
    t0 = time.perf_counter()
    while not all(Path(p).exists() for p in paths):
        if time.perf_counter() - t0 > PHASE_TIMEOUT_S:
            fail(f"the phases beside the checks ({', '.join(BESIDE_CHECKS)}) did not end")
        time.sleep(0.2)
    if paths:
        print(f"checks: waited {time.perf_counter() - t0:.1f} s for the phases beside it",
              flush=True)


def setup(args) -> types.SimpleNamespace:
    """What every phase shares: the families and their wrappers, the keys,
    the simulated observations of Path A (not made for the AIS and decode
    phases, which run no filter) and ``drive``, which runs one
    main-path call with every kernel's count set to 0 just before, reads
    the counts just after (into ``path_launches`` and ``results``) and
    fails if an expected wrapper was launched no time."""
    from repro_torch import random as trandom
    from repro_torch.core.spec import (
        MegopolisSpec,
        MetropolisC1Spec,
        MetropolisC2Spec,
        MetropolisSpec,
        PrefixSumSpec,
        RejectionSpec,
    )
    from repro_torch.kernels.fixtures import fixtures as fk
    from repro_torch.kernels.megopolis import megopolis as mk
    from repro_torch.kernels.metropolis import c1c2 as ck
    from repro_torch.kernels.metropolis import metropolis as tk
    from repro_torch.kernels.prefix_sum import prefix_sum as pk
    from repro_torch.kernels.prefix_sum import search as sk
    from repro_torch.kernels.prefix_sum import step as stk
    from repro_torch.kernels.reduce import reduce as lk
    from repro_torch.kernels.rejection import rejection as rk
    from repro_torch.pf.filter import simulate
    from repro_torch.pf.models import ungm, ungm_family

    dev = torch.device("cuda")
    families = {
        "megopolis": {"spec": MegopolisSpec(num_iters=ITERS), "cls": MegopolisSpec,
                      "alg6": mk.megopolis_fused, "conditional": mk.megopolis_step,
                      "bank_alg6": mk.megopolis_fused_rows,
                      "bank_conditional": mk.megopolis_step_rows,
                      "batch_rows": mk.megopolis_rows, "single": mk.megopolis,
                      "batch": mk.megopolis_batch},
        "metropolis": {"spec": MetropolisSpec(num_iters=ITERS), "cls": MetropolisSpec,
                       "alg6": tk.metropolis_fused, "conditional": tk.metropolis_step,
                       "bank_alg6": tk.metropolis_fused_batch,
                       "bank_conditional": tk.metropolis_step_rows,
                       "batch_rows": tk.metropolis_batch, "single": tk.metropolis,
                       "batch": tk.metropolis_batch},
    }
    for cls in (MetropolisC1Spec, MetropolisC2Spec):
        c = cls.name
        families[c] = {"spec": cls(num_iters=ITERS), "cls": cls,
                       "alg6": getattr(ck, f"{c}_fused"), "conditional": getattr(ck, f"{c}_step"),
                       "bank_alg6": getattr(ck, f"{c}_fused_batch"),
                       "bank_conditional": getattr(ck, f"{c}_step_rows"),
                       "batch_rows": getattr(ck, f"{c}_batch"), "single": getattr(ck, c),
                       "batch": getattr(ck, f"{c}_batch")}
    for f in families.values():
        f.update(path_b=True, small=f["cls"](num_iters=16))
    families["rejection"] = {
        "spec": RejectionSpec(max_iters=REJECTION_MAX_ITERS), "cls": RejectionSpec,
        "alg6": rk.rejection_fused, "conditional": rk.rejection_step,
        "bank_alg6": rk.rejection_fused_batch, "bank_conditional": rk.rejection_step_rows,
        "batch_rows": rk.rejection_batch, "single": rk.rejection, "batch": rk.rejection_batch,
        "path_b": False, "small": RejectionSpec(max_iters=REJECTION_MAX_ITERS)}
    # A wrapper tuple: the entry launches each of them.  The prefix-sum
    # wrappers take banks: one population is a bank of one row.
    prefix_index = (pk.prefix_sum_rows, sk.searchsorted_rows)
    for kind in PATH_A_PREFIX_KINDS:
        fused = (pk.prefix_sum_rows, sk.residual_select_gather_rows if kind == "residual"
                 else sk.searchsorted_gather_rows)
        families[kind] = {
            "spec": PrefixSumSpec(kind=kind), "cls": PrefixSumSpec,
            "alg6": fused, "conditional": stk.prefix_step_rows, "bank_alg6": fused,
            "bank_conditional": stk.prefix_step_rows, "batch_rows": prefix_index,
            "single": prefix_index, "batch": prefix_index,
            "path_b": False, "small": PrefixSumSpec(kind=kind)}
    # Compressed planes on Paths A and B: the families of PATH_PLANES at
    # each of its dtypes, through the same wrappers (their runs' launches
    # are counted under ``<wrapper>@<dtype>``).
    for plane, bases in PATH_PLANES.items():
        for base in bases:
            f = families[base]
            families[f"{base}@{plane}"] = dict(
                f, spec=f["spec"].replace(plane_dtype=plane),
                small=f["small"].replace(plane_dtype=plane), plane=plane)
    modules = (mk, tk, ck, rk, pk, sk, stk, fk, lk)
    wrappers = sum((m.WRAPPERS for m in modules), ())
    key = trandom.PRNGKey(args.seed)
    k_sim, k_run, k_bank, k_quality = trandom.split(key, 4)
    model, fam = ungm(), ungm_family()
    thetas = {"amp": torch.linspace(6.0, 10.0, args.bank),
              "obs_var": torch.linspace(0.5, 2.0, args.bank)}
    truth = obs = bank_truth = bank_obs = None
    if args.phase not in ("ais", "decode"):
        truth, obs = simulate(k_sim, model, args.steps, device=dev)
        sims = [simulate(k, fam, args.bank_steps, theta={"amp": thetas["amp"][i],
                                                         "obs_var": thetas["obs_var"][i]},
                         device=dev)
                for i, k in enumerate(trandom.split(k_bank, args.bank))]
        bank_truth = torch.stack([x for x, _ in sims])
        bank_obs = torch.stack([z for _, z in sims])
    path_launches, results = {}, {}

    def drive(name, fn, expected, n_steps=None):
        # A compressed family's run (its name ends in "@<dtype>") counts its
        # launches under "<wrapper>@<dtype>".
        plane = "@" + name.rsplit("@", 1)[1] if "@" in name else ""
        for module in modules:
            module.reset_launch_counts()
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t_start
        counts = {w.__name__: w.launches for w in wrappers if w.launches}
        expected = [w for e in expected for w in (e if isinstance(e, tuple) else (e,))]
        for wrapper in expected:
            if counts.get(wrapper.__name__, 0) < 1:
                fail(f"{name}: {wrapper.__name__} was launched no time ({counts})")
        for wname, c in counts.items():
            path_launches[wname + plane] = path_launches.get(wname + plane, 0) + c
        results[name] = {"seconds": secs, "launches": counts}
        if n_steps:
            results[name]["steps_per_s"] = n_steps / secs
        return out

    return types.SimpleNamespace(
        dev=dev, n=args.particles, args=args, families=families, prefix_index=prefix_index,
        path_b_families={name: f for name, f in families.items() if f["path_b"]},
        wrappers=wrappers, trandom=trandom, mk=mk, fk=fk, lk=lk, k_run=k_run,
        k_quality=k_quality,
        model=model, fam=fam, truth=truth, obs=obs, thetas=thetas,
        bank_truth=bank_truth, bank_obs=bank_obs,
        path_launches=path_launches, results=results, drive=drive)


def checks_phase(ctx) -> list:
    """Phase 3: the contract checks (``contract_checks``), then the fixture
    kernels against their plain versions; returns their ``kernels``
    entries (the N = 2^23 cases are printed, not listed)."""
    from repro_torch.analysis import fixtures as afix

    contract_checks(ctx.dev, ctx.wrappers, ctx.fk, ctx.lk, ctx.drive)
    wait_for_beside()
    entries = [check_kernel(case) for case in fixture_cases(ctx.dev, ctx.fk, afix)]
    return [e for e in entries if e["name"] in TPU_KERNELS]


def kernels_phase(ctx) -> list:
    """Phase 4: the random-read yardstick (``gather_probe``), then each
    wrapper's kernel against its plain version on inputs captured from short
    full-width runs, timed and bounded, and each bank step's grid study;
    returns the ``kernels`` entries of rows 1-29."""
    a = ctx.args
    kernels = []
    gather_probe(a.seed, ctx.dev)
    t0 = time.perf_counter()
    cases = kernel_cases(a, ctx.dev, ctx.families, ctx.model, ctx.fam, ctx.obs, ctx.bank_obs,
                         ctx.thetas, ctx.k_run, ctx.k_quality)
    took = collections.Counter(capture=time.perf_counter() - t0)
    print("cut phase 4: the kernels of rows 1-29 at float16 planes are held bit for bit and "
          "not timed (their times were within 1.5% of bfloat16's; the whole run's time)",
          flush=True)
    for case in cases:
        t0 = time.perf_counter()
        timed = not case[0].endswith("@float16")
        entry = check_kernel(case, timed)
        # Not the extra cases (where rejection's cap binds, a CESS round's
        # reduction), nor the ones held and not timed.
        if timed and case[0].split("@")[0] in {**TPU_KERNELS, **PORT_KERNELS}:
            kernels.append(entry)
        if case[0].endswith("_step_rows"):
            print(f"grid {case[0]}: {json.dumps(grid_study(case))}", flush=True)
        took[case[4] + ("@" + case[0].split("@")[1] if "@" in case[0] else "")] += (
            time.perf_counter() - t0)
    print(f"time phase 4 (s): {json.dumps({k: round(v, 1) for k, v in took.items()})}")
    return kernels


def guard_phase(ctx) -> list:
    """Phase ``guard``, young for the profiler: Path D, the degeneracy guard
    at full width (``path_d``), then the reference backend on the card
    (``reference_on_card``).  No kernel is new here, so it lists no
    ``kernels`` entry; its runs' launches count with the paths'."""
    import concurrent.futures

    a = ctx.args
    key = ctx.trandom.fold_in(ctx.k_quality, 14)
    t0 = time.perf_counter()
    # The reference backend's CPU half runs in a thread beside Path D (torch
    # releases the GIL in its ops; Path D waits on the card).
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        on_cpu = pool.submit(reference_on_cpu, key)
        path_d(a, ctx.dev, ctx.fam, ctx.bank_obs, ctx.thetas, ctx.k_run, ctx.families,
               ctx.drive, ctx.results)
        t1 = time.perf_counter()
        reference_on_card(ctx.dev, key, on_cpu.result(), ctx.drive, ctx.results)
    print(f"time phase guard (s): path D {t1 - t0:.1f}, reference "
          f"{time.perf_counter() - t1:.1f} after it", flush=True)
    return []


def ais_phase(ctx) -> list:
    """Phase ``ais``, Path E, young for the profiler and alone on the card
    (its runs are timed): ``path_e``.  No kernel is new here, so it lists no
    ``kernels`` entry; its runs' launches count with the paths'."""
    t0 = time.perf_counter()
    print(f"cut path E: E1's and E4's banks take {AIS_BANK} rows, not {AIS_BANK_FULL} (the "
          "whole run's 600 s)", flush=True)
    path_e(ctx, ctx.trandom.fold_in(ctx.k_quality, AIS_KEY))
    print(f"time path E: {time.perf_counter() - t0:.1f} s", flush=True)
    return []


def decode_phase(ctx) -> list:
    """Phase ``decode``, Path G, young for the profiler and alone on the
    card (its runs are timed): ``path_g``.  Its kernel's int32-state case
    is phase 4's (``decode_step_case``), so it lists no ``kernels`` entry;
    its runs' launches count with the paths', under ``megopolis_step@int32``."""
    t0 = time.perf_counter()
    path_g(ctx)
    print(f"time path G: {time.perf_counter() - t0:.1f} s", flush=True)
    return []


def resilience_phase(ctx) -> list:
    """Phase ``resilience``, Path F (DESIGN.md §15-16), beside the checks
    phase: ``path_f``.  No kernel is new here, so it lists no ``kernels``
    entry; its runs' launches count with the paths'."""
    t0 = time.perf_counter()
    path_f(ctx, ctx.trandom.fold_in(ctx.k_quality, RESILIENCE_KEY))
    print(f"time path F: {time.perf_counter() - t0:.1f} s", flush=True)
    return []


#: Path F's key: ``fold_in(k_quality, RESILIENCE_KEY)``.
RESILIENCE_KEY = 26
#: F3's bank: clean rows and one row of each fault, NaN and inf weights at
#: FAULT_RATE (the JAX chaos suite's classes).
FAULT_RATE = 0.1
#: F4's snapshots: every CKPT_EVERY steps, the crash after CKPT_FAIL_AFTER;
#: AIS at its own period.
CKPT_EVERY, CKPT_FAIL_AFTER = 25, 50
AIS_CKPT_EVERY, AIS_CKPT_FAIL_AFTER = 8, 16
#: The CUDA error F2's refused rung reports: no kernel image for the device.
REFUSED_LAUNCH = 209


def path_f(ctx, key):
    """Path F, the resilience layer and the distributed resampler on the
    card at full width, each run with every kernel's launch count set to 0
    just before and read just after (``drive``):

    * F1, spans: one Megopolis conditional filter step (``step_conditional``)
      at N with tracing on, profiled: the ``megopolis/cuda/step/float32``
      span encloses the step kernel's launch, and the port's launch census
      is the same with tracing on and off;
    * F2, fallback: ``build_resilient`` on a healthy ``cuda`` rung emits no
      event and its probe launches the kernel; with the kernel's launch
      refused (its C entry made to return CUDA error REFUSED_LAUNCH) it
      emits exactly one ``backend_demotion`` event and returns a
      ``reference`` resampler equal to ``backend="reference"`` bit for bit
      on N weights;
    * F3, chaos: a bank of clean rows and one of each ``FAULT_CLASSES`` bank,
      NaN and inf weights at FAULT_RATE, through every float32 Path A
      family's ``step_rows`` at ``guard="recover"``: the clean rows equal
      ``guard="off"`` bit for bit, every particle is finite and
      ``validate_ancestors`` passes; ``poison_ancestors`` makes it raise;
    * F4, kill and resume: ``run_filter`` (Megopolis, conditional, Path A's
      N, B and T) with ``CheckpointPolicy(every=CKPT_EVERY,
      fail_after=CKPT_FAIL_AFTER)`` crashes, resumes and equals the
      uninterrupted run on every leaf; so does ``run_smc_sampler`` (E3's
      adaptive MALA, N, T = 24) at AIS_CKPT_EVERY and AIS_CKPT_FAIL_AFTER;
    * F5, distributed: ``make_distributed_resampler`` over NCCL at world
      size 1 (static and dynamic), bit for bit with ``megopolis_hier_ref(
      n_shards=1)`` on the card, and ``gather_ancestors`` and
      ``effective_sample_size`` over the same group."""
    from repro_torch.ais import SMCSamplerConfig, gaussian_mixture, run_smc_sampler
    from repro_torch.analysis.contracts import record
    from repro_torch.core.spec import MegopolisSpec, spec_for_backend
    from repro_torch.obs import trace
    from repro_torch.pf.filter import ParticleFilter, run_filter
    from repro_torch.resilience import faults
    from repro_torch.resilience.checkpointing import CheckpointPolicy
    from repro_torch.resilience.errors import CorruptAncestorsError, InjectedCrash

    dev, drive, results, n, trandom = ctx.dev, ctx.drive, ctx.results, ctx.n, ctx.trandom
    mk, fams = ctx.mk, ctx.families
    lap = time.perf_counter()

    def took(what):
        nonlocal lap
        print(f"time path F {what}: {time.perf_counter() - lap:.1f} s", flush=True)
        lap = time.perf_counter()

    # -- F1 -------------------------------------------------------------------------
    pf = ParticleFilter(ctx.model, n, resampler=fams["megopolis"]["spec"], ess_threshold=THR)
    k1 = trandom.fold_in(key, 1)
    x = ctx.model.init(k1, n, dev)
    lw = torch.zeros(n, device=dev)
    t1 = torch.tensor(1.0, device=dev)

    def one_step():
        out = pf.step_conditional(k1, x, lw, ctx.obs[0], t1)
        torch.cuda.synchronize()
        return out

    off, rec_off = record(one_step, taint=False)
    trace.enable_tracing(True)
    try:
        on, rec_on = record(one_step, taint=False)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            drive("resilience/f1/spans", one_step, [fams["megopolis"]["conditional"]])
    finally:
        trace.enable_tracing(False)
    # The span is a host range (around the launch call) and, on the device's
    # timeline, an annotation of the same name (around the kernel).
    name, cuda = "megopolis/cuda/step/float32", torch.autograd.DeviceType.CUDA
    events = prof.events()

    def within(e, outer):
        return outer.time_range.start <= e.time_range.start and \
            e.time_range.end <= outer.time_range.end

    spans = [e for e in events if e.name == name and e.device_type != cuda]
    marks = [e for e in events if e.name == name and e.device_type == cuda]
    kernels = [e for e in events if e.device_type == cuda
               and is_kernel(e.name, "megopolis_step_rows_kernel")]
    launches = [e for e in events if "LaunchCooperativeKernel" in e.name]
    same = all(torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                           b.view(torch.int32) if b.is_floating_point() else b)
               for a, b in zip(on[:3], off[:3]))
    f1 = {"host_spans": len(spans), "device_spans": len(marks), "step_kernels": len(kernels),
          "kernel_launch_calls": len(launches),
          "launch_calls_inside_host_span": sum(within(e, s) for e in launches for s in spans),
          "kernels_inside_device_span": sum(within(k, m) for k in kernels for m in marks),
          "census_off": dict(rec_off.census), "census_on": dict(rec_on.census),
          "outputs_equal": same}
    results["resilience/f1/spans"].update(f1)
    print(f"path F1: {json.dumps(f1)}", flush=True)
    if len(spans) != 1 or len(kernels) != 1 or len(launches) != 1 or \
            f1["launch_calls_inside_host_span"] != 1 or \
            (marks and f1["kernels_inside_device_span"] != 1):
        fail(f"F1: the span {name} does not enclose the step kernel: {f1}")
    if dict(rec_on.census) != dict(rec_off.census) or not rec_off.census or not same:
        fail(f"F1: tracing moved the census or the result: {f1}")
    took("F1")

    # -- F2 -------------------------------------------------------------------------
    spec = fams["megopolis"]["spec"]
    events = []
    mk.reset_launch_counts()
    healthy = spec.build_resilient(recorder=events, device=dev)
    probe_launches = mk.megopolis.launches
    if events or healthy.backend != "cuda" or probe_launches != 1:
        fail(f"F2: the healthy rung demoted or its probe did not launch the kernel "
             f"({events}, {healthy.backend}, {probe_launches} launches)")
    real_lib = mk._lib

    class Refusing:
        """The Megopolis library with its index-only entry refused."""

        def __getattr__(self, attr):
            got = getattr(real_lib(), attr)
            return (lambda *a: REFUSED_LAUNCH) if attr == "megopolis_rows" else got

    mk._lib = Refusing
    try:
        demoted = drive("resilience/f2/fallback",
                        lambda: spec.build_resilient(recorder=events, device=dev), [])
    finally:
        mk._lib = real_lib
    w = torch.rand(n, generator=torch.Generator(device=dev).manual_seed(26), device=dev)
    k2 = trandom.fold_in(key, 2)
    got = demoted(k2, w)
    want = spec.replace(backend="reference").build()(k2, w)
    f2 = {"healthy_events": 0, "healthy_probe_launches": probe_launches,
          "events": [{k: e[k] for k in ("kind", "backend", "to_backend", "error_type")}
                     for e in events], "demoted_backend": demoted.backend,
          "ancestors_equal": bool(torch.equal(got, want))}
    results["resilience/f2/fallback"].update(f2)
    print(f"path F2: {json.dumps(f2)}", flush=True)
    if [e["kind"] for e in events] != ["backend_demotion"] or demoted.backend != "reference" \
            or events[0]["to_backend"] != "reference" or not f2["ancestors_equal"]:
        fail(f"F2: expected one demotion to reference, equal to it bit for bit: {f2}")
    took("F2")

    # -- F3 -------------------------------------------------------------------------
    rows = ("clean", *faults.FAULT_CLASSES, "nan_weights", "inf_weights", "clean")
    g = torch.Generator(device=dev).manual_seed(3)
    clean = 3.0 * torch.randn(len(rows), n, generator=g, device=dev)
    k3 = trandom.fold_in(key, 3)
    bank = []
    for i, row in enumerate(rows):
        if row in faults.FAULT_CLASSES:
            bank.append(faults.FAULT_CLASSES[row](n, device=dev))
        elif row == "nan_weights":
            bank.append(faults.inject_nan_weights(trandom.fold_in(k3, i), clean[i], FAULT_RATE))
        elif row == "inf_weights":
            bank.append(faults.inject_inf_weights(trandom.fold_in(k3, i), clean[i], FAULT_RATE))
        else:
            bank.append(clean[i])
    lw_bank = torch.stack(bank)
    parts = torch.randn(len(rows), n, generator=g, device=dev)
    keys = trandom.split(trandom.fold_in(k3, 99), len(rows))
    keep = [i for i, row in enumerate(rows) if row == "clean"]
    f3 = {}
    for family, f in fams.items():
        if "plane" in f:
            continue
        out = {}
        for guard in ("off", "recover"):
            r = f["spec"].replace(guard=guard).build()
            out[guard] = drive(f"resilience/f3/{family}/{guard}",
                               lambda r=r: r.step_rows(keys, lw_bank, parts, THR),
                               [f["bank_conditional"]])
        (p_rec, a_rec, st), (p_off, a_off, _) = out["recover"], out["off"]
        faults.validate_ancestors(a_rec, n)
        try:
            faults.validate_ancestors(faults.poison_ancestors(trandom.fold_in(k3, 7), a_rec, n),
                                      n)
            fail(f"F3 {family}: validate_ancestors passed poisoned ancestors")
        except CorruptAncestorsError:
            pass
        f3[family] = {"clean_equal": bool(torch.equal(a_rec[keep], a_off[keep]) and torch.equal(
            p_rec[keep].view(torch.int32), p_off[keep].view(torch.int32))),
            "finite": bool(torch.isfinite(p_rec).all()),
            "degenerate_rows": st.degenerate.nonzero().reshape(-1).tolist()}
        if not (f3[family]["clean_equal"] and f3[family]["finite"]):
            fail(f"F3 {family}: {f3[family]}")
        del out, p_rec, a_rec, p_off, a_off
    results["resilience/f3/chaos"] = {"rows": list(rows), "families": f3}
    print(f"path F3: {json.dumps(results['resilience/f3/chaos'])}", flush=True)
    took("F3")

    # -- F4 -------------------------------------------------------------------------
    def bits_of(x):
        x = x.reshape(-1)
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    def crash_then_resume(name, run, policy_kw, leaves, expected):
        full = drive(f"{name}/uninterrupted", run, expected)
        with tempfile.TemporaryDirectory() as d:
            crashed = []

            def crash():
                try:
                    run(CheckpointPolicy(d, **policy_kw))
                except InjectedCrash as err:
                    crashed.append(str(err))
            drive(f"{name}/crash", crash, expected)
            resumed = drive(f"{name}/resumed", lambda: run(CheckpointPolicy(
                d, every=policy_kw["every"])), expected)
        names, want = leaves(full)
        differ = {k: int((bits_of(a) != bits_of(b)).sum())
                  for k, a, b in zip(names, leaves(resumed)[1], want, strict=True)}
        rec = {"crash": crashed, "values_differing": differ,
               "seconds": [results[f"{name}/{p}"]["seconds"] for p in
                           ("uninterrupted", "crash", "resumed")]}
        results[name] = rec
        print(f"path {name}: {json.dumps(rec)}", flush=True)
        if len(crashed) != 1 or any(differ.values()):
            fail(f"{name}: the resumed run differs from the uninterrupted one: {rec}")

    def filter_leaves(out):
        est, tel = out
        return (("estimates", *tel.steps._fields), (est, *tel.steps))

    crash_then_resume(
        "resilience/f4/run_filter/megopolis",
        lambda ck=None: run_filter(ctx.k_run, pf, ctx.obs, telemetry=True, checkpoint=ck,
                                   device=dev),
        {"every": CKPT_EVERY, "fail_after": CKPT_FAIL_AFTER}, filter_leaves,
        [fams["megopolis"]["conditional"]])
    cfg = SMCSamplerConfig(num_particles=n, num_temps=AIS_TEMPS, schedule="adaptive",
                           move="mala", resampler=spec_for_backend("megopolis", "cuda",
                                                                   num_iters=AIS_ITERS))
    target = gaussian_mixture(device=dev)
    k4 = trandom.fold_in(key, 4)
    crash_then_resume(
        "resilience/f4/run_smc_sampler/megopolis",
        lambda ck=None: run_smc_sampler(k4, target, cfg, checkpoint=ck, device=dev),
        {"every": AIS_CKPT_EVERY, "fail_after": AIS_CKPT_FAIL_AFTER},
        lambda out: (tuple(sorted(out)), tuple(out[k] for k in sorted(out))),
        [fams["megopolis"]["conditional"], ctx.lk.logsumexp_rows])
    took("F4")

    # -- F5 -------------------------------------------------------------------------
    import socket

    import torch.distributed as dist

    from repro_torch.core import distributed as td
    from repro_torch.kernels.common import key_to_seed

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        k5 = trandom.fold_in(key, 5)
        dspec = MegopolisSpec(num_iters=ITERS, backend="reference")
        ks, kl, kh = trandom.split(k5, 3)
        f5 = {"backend": dist.get_backend(), "world_size": dist.get_world_size()}
        for schedule in ("static", "dynamic"):
            r = td.make_distributed_resampler(spec=dspec, schedule=schedule)
            got = drive(f"resilience/f5/{schedule}", lambda r=r: r(k5, w), [])
            shards = (td._static_shard_schedule(0xA5A5, ITERS, 1) if schedule == "static"
                      else trandom.randint(kh, (ITERS,), 0, 1))
            want = td.megopolis_hier_ref(key_to_seed(ks), trandom.randint(kl, (ITERS,), 0, n),
                                         shards, w, n_shards=1, num_iters=ITERS)
            f5[schedule] = {"equal": bool(torch.equal(got, want)),
                            "moved": float((got != torch.arange(n, device=dev)).float().mean())}
        xs = torch.randn(n, generator=g, device=dev)
        f5["gather_equal"] = bool(torch.equal(td.gather_ancestors(xs, got), xs[got]))
        s1, s2 = w.sum(), (w * w).sum()
        f5["ess"] = float(td.effective_sample_size(w))
        f5["ess_one_device"] = float(s1 * s1 / torch.clamp(s2, min=1e-30))
    finally:
        dist.destroy_process_group()
    results["resilience/f5/distributed"] = f5
    print(f"path F5: {json.dumps(f5)}", flush=True)
    if not (f5["static"]["equal"] and f5["dynamic"]["equal"] and f5["gather_equal"]
            and f5["ess"] == f5["ess_one_device"]):
        fail(f"F5: the distributed resampler differs from its one-device oracle: {f5}")
    took("F5")


def ais_steps(families: dict) -> dict:
    """Each AIS family's step wrappers, read from ``setup``'s table, with
    the plain version of each on the wrapper's own arguments and the
    ``ops`` module that calls them (where ``capture`` finds them):
    ``{"single": (wrapper, plain), "bank": (wrapper, plain), "ops": module}``.
    Systematic's one population is a bank of one row; only Megopolis's
    single-population step is held (E3)."""
    from repro_torch.kernels.megopolis import ops as mops
    from repro_torch.kernels.megopolis import ref as mref
    from repro_torch.kernels.metropolis import ops as tops
    from repro_torch.kernels.metropolis import ref as tref
    from repro_torch.kernels.prefix_sum import ops as pops
    from repro_torch.kernels.prefix_sum import ref as pref
    from repro_torch.kernels.prefix_sum import step as stk
    from repro_torch.kernels.rejection import ops as rops
    from repro_torch.kernels.rejection import ref as rref

    def megopolis_one(lw, st, offs, seed, thr):
        return mref.megopolis_step_rows_ref(lw[None], st[None], offs[None], seed.reshape(1), thr)

    plain = {"megopolis": (mops, megopolis_one, mref.megopolis_step_rows_ref),
             "metropolis": (tops, None, tref.metropolis_step_rows_ref),
             "rejection": (rops, None, rref.rejection_step_rows_ref),
             "systematic": (pops, pref.prefix_step_rows_ref, pref.prefix_step_rows_ref)}
    out = {}
    for f, (ops, one, rows) in plain.items():
        single, bank = ((stk.prefix_step_rows,) * 2 if f == "systematic" else
                        (families[f]["conditional"], families[f]["bank_conditional"]))
        out[f] = {"single": (single, one), "bank": (bank, rows), "ops": ops}
    return out


def ais_quality(name: str, out: dict, truth: float) -> dict:
    """logZ over a run's rows against the analytic truth, held to
    ``test_ais.py``'s gate (|logZ - truth| <= 0.1 + 0.1·|truth| on every
    row); fails on a non-finite particle or a β ladder that does not end at
    exactly 1.0."""
    if not bool(torch.isfinite(out["particles"]).all()):
        fail(f"{name}: non-finite particles")
    log_z = out["log_z"].reshape(-1).double().cpu()
    err = (log_z - truth).abs()
    gate = 0.1 + 0.1 * abs(truth)
    if not bool((err <= gate).all()):
        fail(f"{name}: logZ {log_z.tolist()} outside {truth} ± {gate}")
    betas = out["betas"].reshape(-1, out["betas"].shape[-1]).cpu()
    if not bool((betas[:, -1] == 1.0).all()):
        fail(f"{name}: the β ladder ends at {betas[:, -1].tolist()}, not 1.0")
    res = out["num_resamples"].reshape(-1).double().cpu()
    return {"rows": log_z.numel(), "truth": truth, "gate": gate,
            "log_z_mean": float(log_z.mean()), "bias": float(log_z.mean() - truth),
            "std": float(log_z.std()) if log_z.numel() > 1 else 0.0,
            "rmse": float(((log_z - truth) ** 2).mean().sqrt()), "max_abs_err": float(err.max()),
            "resamples_per_row": float(res.mean()),
            "temps_used": int((betas < 1.0).sum(dim=1).max()) + 1}


def ais_hold(name: str, step: tuple, ops, run) -> tuple:
    """``run()`` with the arguments of one call of the step wrapper of
    ``step = (wrapper, plain)`` captured (``capture``: the last call after
    which a row resampled), then the wrapper held against its plain version
    on those card inputs (``hold_step``).  Returns the run's output and the
    hold's record.  Its launches are not the main path's: ``drive`` sets
    the counts to 0 before each of its runs."""
    wrapper, plain = step
    box = []
    kargs = capture(ops, wrapper.__name__, lambda: box.append(run()))
    want = plain(*kargs)
    err = hold_step(f"{name}: {wrapper.__name__}", wrapper(*kargs), want)
    return box[0], {"held": wrapper.__name__, "held_planes": list(kargs[1].shape),
                    "held_dtype": str(kargs[1].dtype).removeprefix("torch."),
                    "held_rows_resampled": int(want[2].reshape(-1, 4)[:, 2].sum()),
                    "held_max_abs_err": err}


#: The separator between the profiled runs of Path E: ``torch.cuda._sleep``
#: launches PyTorch's ``spin_kernel`` (in a namespace: ``at::cuda::...``),
#: which no run launches.
AIS_SEPARATOR = "spin_kernel"
AIS_SEPARATOR_CYCLES = 1000


def ais_run_profiles(prof, walls: list, temps: int) -> list:
    """One profile of consecutive runs, each launched after a separator
    kernel (``AIS_SEPARATOR``), split at the separators: per run, all CUDA
    kernel launches and the port's among them per temperature, the device
    time, the run's wall time under the profiler and the device's busy
    share of that wall time.  One session for all runs: starting and
    stopping the profiler around each run took about 3 s a run on the H100.
    None per run if the profiler dropped a separator."""
    from repro_torch.analysis import smem

    events = device_events(prof)
    groups = []
    for _, name, us in events:
        if AIS_SEPARATOR in name:
            groups.append([])
        elif groups:
            groups[-1].append((name, us))
    if len(groups) != len(walls):
        names = sorted({name[:60] for _, name, _ in events})
        print(f"path E: the profile holds {len(groups)} separators for {len(walls)} runs; "
              f"its launches and busy shares are not measured (kernels seen: {names})",
              flush=True)
        return [None] * len(walls)
    out = []
    for group, wall in zip(groups, walls):
        device_ms = sum(us for _, us in group) / 1e3
        out.append({"cuda_launches_per_temp": len(group) / temps,
                    "port_launches_seen_per_temp": sum(
                        1 for name, _ in group if kernel_instance(name) in smem.KERNELS) / temps,
                    "device_ms": device_ms, "seconds_profiled": wall,
                    "device_busy_share_profiled": device_ms / (wall * 1e3)})
    return out


def ais_differing(a: dict, b: dict) -> dict:
    """Per leaf, how many values of ``a`` differ from ``b``'s."""
    return {name: int((a[name].reshape(-1) != b[name].reshape(-1)).sum()) for name in b}


def ais_same(name: str, out: dict, held: dict):
    """Fail unless a timed run repeats its held run (same key, same inputs)
    bit for bit, so the inputs held are the timed run's."""
    differ = ais_differing(out, held)
    if any(differ.values()):
        fail(f"{name}: the timed run differs from its held run: {differ}")


def path_e(ctx, key):
    """Path E, the AIS sampler (DESIGN.md §10) on the card, each timed run
    with every kernel's launch count set to 0 just before and read just
    after (``drive``):

    * E1, quality: ``run_smc_sampler_bank`` of AIS_BANK i.i.d. rows at N
      particles, d = 2, on ``isotropic_gaussian`` and ``gaussian_mixture``,
      for each family of AIS_FAMILIES (``cuda``, float32): logZ mean, bias,
      std and RMSE over the rows, resamples per row, seconds, the port's
      launches per temperature (the census); every row inside the gate.
      First one profile of every E1-E2 run, split at separator kernels,
      which also warms each run up: all CUDA launches per temperature and
      the device time.  Then each run timed alone, without the profiler;
      the device's busy share is the profile's device time over that wall
      time.  Before each family's isotropic run, the same run once more with
      one call of its step wrapper captured and held against the plain
      version on those [S, D, N] inputs (``ais_hold``);
    * E2, the §4 contract: ``run_smc_sampler(split(key, S)[AIS_E2_ROW])``,
      Megopolis, equal to E1's bank row bit for bit on every leaf;
    * E3, the adaptive ladder with MALA: ``run_smc_sampler`` at N on both
      targets (gate, β reaching exactly 1.0, temperatures used, seconds),
      the first after a held run of the same call (its warm-up), then a
      bank of AIS_E3_BANK rows on the mixture, its row AIS_E3_ROW equal to
      the single call on every leaf, bit for bit (the CESS bisection's
      reductions are ``logsumexp_rows``, whose order follows N, never S);
    * E4, compressed planes: E1's isotropic bank at ``plane_dtype`` AIS_PLANE
      for AIS_PLANE_FAMILIES, inside the gate, each after a held run;
    * E5, the card against the CPU: N = AIS_SMALL_N, T = AIS_SMALL_TEMPS,
      Megopolis, one key: β within 1 ULP (the card's ``pow``), logZ within
      ``SMALL_RUN_ATOL``; telemetry on and off on the card: the same
      census and a bit-identical result; and one profile of that run read
      both through ``prof.events()`` and raw (``ais_readers``)."""
    from repro_torch import random as trandom
    from repro_torch.ais import (
        SMCSamplerConfig,
        gaussian_mixture,
        isotropic_gaussian,
        run_smc_sampler,
        run_smc_sampler_bank,
    )
    from repro_torch.analysis.contracts import record
    from repro_torch.core.spec import spec_for_backend

    dev, drive, results = ctx.dev, ctx.drive, ctx.results
    n, temps = ctx.args.particles, AIS_TEMPS
    steps = ais_steps(ctx.families)
    specs = {f: spec_for_backend(f, "cuda", num_iters=AIS_ITERS, max_iters=REJECTION_MAX_ITERS)
             for f in AIS_FAMILIES}
    targets = {"isotropic_gaussian": isotropic_gaussian(dim=2, device=dev),
               "gaussian_mixture": gaussian_mixture(device=dev)}
    lap = time.perf_counter()

    def took(what):
        nonlocal lap
        print(f"time path E {what}: {time.perf_counter() - lap:.1f} s", flush=True)
        lap = time.perf_counter()

    def bank_call(spec, target):
        cfg = SMCSamplerConfig(num_particles=n, num_temps=temps, resampler=spec)
        return lambda: run_smc_sampler_bank(key, target, cfg, num_scenarios=AIS_BANK, device=dev)

    def bank_quality(name, out, target):
        rec = results[name]
        rec.update(ais_quality(name, out, target.log_z), seconds_per_row=rec["seconds"] / AIS_BANK,
                   port_launches_per_temp=sum(rec["launches"].values()) / temps)

    # -- E1 and E2: one profile of every run, then each run timed alone -----------
    runs = {f"ais/e1/{family}/{tname}": (family, tname, "bank",
                                         bank_call(specs[family], target))
            for family in AIS_FAMILIES for tname, target in targets.items()}
    e2 = "ais/e2/megopolis/isotropic_gaussian"
    e2_key = trandom.split(key, AIS_BANK)[AIS_E2_ROW]
    e2_cfg = SMCSamplerConfig(num_particles=n, num_temps=temps, resampler=specs["megopolis"])
    runs[e2] = ("megopolis", "isotropic_gaussian", "single", lambda: run_smc_sampler(
        e2_key, targets["isotropic_gaussian"], e2_cfg, device=dev))
    walls = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _, _, _, run in runs.values():
            torch.cuda._sleep(AIS_SEPARATOR_CYCLES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    profiles = dict(zip(runs, ais_run_profiles(prof, walls, temps)))
    del prof
    took("E1-E2 profile")
    e2_want = None
    for name, (family, tname, entry, run) in runs.items():
        held = None
        if entry == "bank" and tname == "isotropic_gaussian":
            held, hold = ais_hold(name, steps[family]["bank"], steps[family]["ops"], run)
        out = drive(name, run, [steps[family][entry][0]])
        rec = results[name]
        rec.update(profiles[name] or {})
        if profiles[name]:
            rec["device_busy_share"] = rec["device_ms"] / (rec["seconds"] * 1e3)
        if held is not None:
            ais_same(name, out, held)
            rec.update(hold)
        del held
        if entry == "bank":
            bank_quality(name, out, targets[tname])
            if family == "megopolis" and tname == "isotropic_gaussian":
                e2_want = {k: v[AIS_E2_ROW].clone() for k, v in out.items()}
        else:
            differ = ais_differing(e2_want, out)
            rec.update(row=AIS_E2_ROW, values_differing=differ)
            if any(differ.values()):
                fail(f"E2: bank row {AIS_E2_ROW} differs from its single call: {differ}")
        del out
    compare = collections.defaultdict(dict)
    for name in (name for name in runs if name.startswith("ais/e1/")):
        family, tname = name.split("/")[2:]
        compare[tname][family] = {k: results[name].get(k) for k in (
            "log_z_mean", "bias", "std", "rmse", "resamples_per_row", "seconds",
            "seconds_profiled", "port_launches_per_temp", "cuda_launches_per_temp",
            "device_ms", "device_busy_share", "device_busy_share_profiled",
            "held_max_abs_err")}
    for tname, side in compare.items():
        print(f"compare ais/e1/{tname}: {json.dumps(side)}", flush=True)
    took("E1-E2 timed and held")

    # -- E3 -----------------------------------------------------------------------
    k3 = trandom.fold_in(key, 3)
    cfg3 = SMCSamplerConfig(num_particles=n, num_temps=temps, resampler=specs["megopolis"],
                            schedule="adaptive", move="mala")
    singles = {}
    for tname, target in targets.items():
        name = f"ais/e3/megopolis/{tname}"
        run = (lambda target=target: run_smc_sampler(
            trandom.split(k3, AIS_E3_BANK)[AIS_E3_ROW], target, cfg3, device=dev))
        held = None
        if not singles:
            held, hold = ais_hold(name, steps["megopolis"]["single"], steps["megopolis"]["ops"],
                                  run)
        singles[tname] = drive(name, run, [steps["megopolis"]["single"][0],
                                           ctx.lk.logsumexp_rows])
        results[name].update(ais_quality(name, singles[tname], target.log_z),
                             betas=singles[tname]["betas"].tolist())
        if held is not None:
            ais_same(name, singles[tname], held)
            results[name].update(hold)
        del held
    name = "ais/e3_bank/megopolis/gaussian_mixture"
    bank = drive(name, lambda: run_smc_sampler_bank(k3, targets["gaussian_mixture"], cfg3,
                                                    num_scenarios=AIS_E3_BANK, device=dev),
                 [steps["megopolis"]["bank"][0], ctx.lk.logsumexp_rows])
    differ = ais_differing({k: v[AIS_E3_ROW] for k, v in bank.items()},
                           singles["gaussian_mixture"])
    results[name].update(ais_quality(name, bank, targets["gaussian_mixture"].log_z),
                         row=AIS_E3_ROW, values_differing=differ)
    if any(differ.values()):
        fail(f"E3: bank row {AIS_E3_ROW} differs from its single call: {differ}")
    print(f"compare ais/e3: {json.dumps({k: results[k] for k in results if '/e3' in k})}",
          flush=True)
    del bank, singles
    took("E3")

    # -- E4 -----------------------------------------------------------------------
    for family in AIS_PLANE_FAMILIES:
        name = f"ais/e4/{family}@{AIS_PLANE}"
        run = bank_call(specs[family].replace(plane_dtype=AIS_PLANE), targets["isotropic_gaussian"])
        held, hold = ais_hold(name, steps[family]["bank"], steps[family]["ops"], run)
        out = drive(name, run, [steps[family]["bank"][0]])
        ais_same(name, out, held)
        results[name].update(hold)
        bank_quality(name, out, targets["isotropic_gaussian"])
        del held, out
    took("E4")

    # -- E5 -----------------------------------------------------------------------
    k5 = trandom.fold_in(key, 5)
    cfg5 = SMCSamplerConfig(num_particles=AIS_SMALL_N, num_temps=AIS_SMALL_TEMPS,
                            resampler=specs["megopolis"])
    small = isotropic_gaussian(dim=2, device=dev)
    on_card = drive("ais/e5/megopolis/card", lambda: run_smc_sampler(k5, small, cfg5, device=dev),
                    [steps["megopolis"]["single"][0]])
    on_cpu = run_smc_sampler(k5, isotropic_gaussian(dim=2, device="cpu"), cfg5, device="cpu")
    beta_ulp = int((on_card["betas"].cpu().view(torch.int32).long()
                    - on_cpu["betas"].view(torch.int32).long()).abs().max())
    logz_gap = abs(float(on_card["log_z"]) - float(on_cpu["log_z"]))
    if beta_ulp > 1 or not logz_gap <= SMALL_RUN_ATOL:
        fail(f"E5: card against CPU, β {beta_ulp} ULP apart, logZ {logz_gap} apart")
    off, rec_off = record(lambda: run_smc_sampler(k5, small, cfg5, device=dev), taint=False)
    (on, tel), rec_on = record(
        lambda: run_smc_sampler(k5, small, cfg5, telemetry=True, device=dev), taint=False)
    differ = ais_differing(on, off)
    if dict(rec_on.census) != dict(rec_off.census) or any(differ.values()):
        fail(f"E5: telemetry moved the census ({dict(rec_off.census)} -> "
             f"{dict(rec_on.census)}) or the result ({differ})")
    results["ais/e5/megopolis/card"].update(
        beta_ulp=beta_ulp, logz_card=float(on_card["log_z"]), logz_cpu=float(on_cpu["log_z"]),
        logz_gap=logz_gap, telemetry_census=dict(rec_on.census),
        telemetry_values_differing=differ, telemetry_fields=list(tel.steps._fields),
        profile_readers=ais_readers(lambda: run_smc_sampler(k5, small, cfg5, device=dev)))
    took("E5")


def ais_readers(run) -> dict:
    """One profile of ``run()`` read both ways: through ``prof.events()``
    and from the raw records (``device_events``, every phase's reader).
    Fails unless both see the same kernel events, name for name, with the
    same durations."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    cooked = sorted((e.name, e.device_time_total) for e in prof.events()
                    if e.device_type == cuda)
    raw = sorted((name, us) for _, name, us in device_events(prof))
    same_names = [name for name, _ in cooked] == [name for name, _ in raw]
    worst = max((abs(a - b) for (_, a), (_, b) in zip(cooked, raw)), default=0.0)
    if not (same_names and worst <= 1e-3):
        fail(f"E5: the profile's readers disagree: {len(cooked)} events through prof.events(), "
             f"{len(raw)} raw, names equal {same_names}, durations up to {worst} µs apart")
    return {"events": len(raw), "device_ms": sum(us for _, us in raw) / 1e3,
            "max_abs_us_apart": worst}


#: Path G, SMC decoding (DESIGN.md §5, ``launch/serve.py``): Qwen3-0.6B at its
#: published width in float32, N particles of the kernels' tile, a prompt of
#: 16 tokens and 32 new ones, Megopolis at B = 16; the target temperature
#: of JAX's ``tests/test_smc.py`` (0.5) and ``serve_once``'s ESS threshold
#: (0.5): the branch fires where the normalised ESS falls below it.
DECODE_ARCH = "qwen3-0.6b"
DECODE_N = 1024
DECODE_PROMPT = 16
DECODE_TOKENS = 32
DECODE_ITERS = 16
DECODE_TARGET_TEMP = 0.5
#: G4, JAX's ``test_ancestor_gather_coherence`` at full width: one prompt for
#: every particle, near-greedy temperatures, its 6 new tokens.
COHERENCE_PROMPT = (1, 2, 3, 4)
COHERENCE_TOKENS = 6
COHERENCE_TEMP = 1e-4
#: G5: the smoke config's prefill logits on the card against the CPU, from
#: the same params: the products sum in other orders (cuBLAS, MKL).
DECODE_CPU_ATOL = 1e-4
#: The cycles of the separator kernel (``torch.cuda._sleep``) G2 launches
#: between the parts of a decode step.
DECODE_SEPARATOR_CYCLES = 1000


def decode_inputs(cfg, n: int, prompt_len: int, seed: int, dev):
    """``serve_once``'s params, prompts and decode key for ``cfg`` (the same
    draws from the same seed): ``(params, prompts, k_decode)``."""
    from repro_torch import random as trandom
    from repro_torch.models import init_params

    k_param, k_prompt, k_decode = trandom.split(trandom.PRNGKey(seed), 3)
    params = init_params(k_param, cfg, device=dev)
    prompts = trandom.randint(k_prompt, (n, prompt_len), 0, cfg.vocab_size, device=dev)
    return params, prompts, k_decode


@contextlib.contextmanager
def decode_parts(labels: list):
    """While open, each part of ``smc_decode``'s step, the model
    (``decode_step``), the categorical draw, the resampler's step entry
    and the KV gather, runs between two separator kernels, and ``labels``
    gets the part's name, then ``"other"`` (the twist, the token write, the
    weights' reset and the ESS), in launch order: the device events between
    two separators are the labelled part's (one stream)."""
    from repro_torch import random as trandom
    from repro_torch.core import spec as tspec
    from repro_torch.smc import decode as sd

    def part(label, fn):
        def run(*args, **kwargs):
            torch.cuda._sleep(DECODE_SEPARATOR_CYCLES)
            labels.append(label)
            out = fn(*args, **kwargs)
            torch.cuda._sleep(DECODE_SEPARATOR_CYCLES)
            labels.append("other")
            return out
        return run

    patched = ((sd, "decode_step", "model"), (trandom, "categorical", "draw"),
               (tspec.Resampler, "step", "step"), (sd, "_gather", "gather"))
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patched]
    for obj, name, label in patched:
        setattr(obj, name, part(label, getattr(obj, name)))
    try:
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def decode_breakdown(prof, labels: list, wall: float, steps: int) -> dict:
    """G2's numbers from one profile of a decode run inside ``decode_parts``:
    per step, all CUDA device operations (kernels, copies, fills) and the
    port's kernels among them, the device ms of each part and of the step
    kernel alone, and the device's busy share of the profiled wall time.
    The split needs every separator: if the profiler dropped one, the parts
    are not measured (printed) and the totals stand."""
    from repro_torch.analysis import smem

    events = [(name, us) for _, name, us in device_events(prof)]
    ops = [(name, us) for name, us in events if AIS_SEPARATOR not in name]
    device_ms = sum(us for _, us in ops) / 1e3
    step_kernel = [us for name, us in ops
                   if kernel_instance(name) == "megopolis_step_rows_kernel<float>"]
    out = {"steps": steps, "cuda_ops_per_step": len(ops) / steps,
           "copies_and_fills_per_step": sum(1 for name, _ in ops
                                            if name.startswith(("Memcpy", "Memset"))) / steps,
           "port_launches_per_step": sum(1 for name, _ in ops
                                         if kernel_instance(name) in smem.KERNELS) / steps,
           "device_ms_per_step": device_ms / steps, "wall_ms_per_step": wall * 1e3 / steps,
           "device_busy_share": device_ms / (wall * 1e3),
           "step_kernel_ms": sum(step_kernel) / 1e3 / max(1, len(step_kernel)),
           "step_kernel_launches": len(step_kernel)}
    groups = [[]]
    for name, us in events:
        if AIS_SEPARATOR in name:
            groups.append([])
        else:
            groups[-1].append(us)
    labels = ["other"] + labels
    if len(groups) != len(labels):
        print(f"path G2: the profile holds {len(groups) - 1} separators for {len(labels) - 1} "
              "part boundaries; the parts' device ms are not measured", flush=True)
        return out
    parts = collections.Counter()
    for label, group in zip(labels, groups):
        parts[label] += sum(group) / 1e3
    out["part_device_ms_per_step"] = {k: v / steps for k, v in parts.items()}
    out["part_device_share"] = {k: v / device_ms for k, v in parts.items()}
    return out


def path_g(ctx):
    """Path G, SMC decoding of Qwen3-0.6B at its published width (28 layers,
    d_model 1024, vocab 151936) in float32 on the card, the Megopolis step
    kernel resampling the particles with the int32 token buffer as its
    state; each run with every kernel's launch count set to 0 just before
    and read just after (``drive``, the launches under
    ``megopolis_step@int32``):

    * G1, ``serve_once`` as a user calls it (DECODE_N particles, a prompt of
      DECODE_PROMPT tokens, DECODE_TOKENS new ones), nothing wrapped
      around it: prefill and decode seconds, tokens a second, resamples,
      the final ESS and the peak of allocated memory; one step launch a
      token, at least one resample, every token in the vocabulary and
      every log-weight finite;
    * G2, the same decode once more, under the profiler, its step's parts
      between separator kernels (``decode_parts``): CUDA operations and
      port launches a step, the device's busy share, and the device ms of
      the model, the categorical draw, the step entry (and its kernel) and
      the KV gather (``decode_breakdown``);
    * G3, the same decode once more, untimed, its step calls captured (a
      wait for the card and copies each step, which G1 and G2 are spared):
      its tokens equal to G1's, and the step kernel held bit for bit
      against its plain version on its last resampling call (log-weights
      ``[N]``, the tokens ``int32[T, N]``);
    * G4, JAX's ``test_ancestor_gather_coherence`` at full width: one
      prompt for every particle and temperatures of COHERENCE_TEMP, and
      every particle's continuation equal;
    * G5, the smoke config on the card against the port on the CPU at N
      particles from the same params: prefill logits within
      DECODE_CPU_ATOL, and the step kernel on a captured call of a card
      decode with the CPU's plain version's ancestors and tokens."""
    import dataclasses

    from repro_torch import random as trandom
    from repro_torch.configs import get_arch
    from repro_torch.convert import _map_tree
    from repro_torch.core.spec import MegopolisSpec
    from repro_torch.kernels.megopolis import ops as mops
    from repro_torch.kernels.megopolis import ref as mref
    from repro_torch.launch.serve import serve_once
    from repro_torch.models import prefill
    from repro_torch.smc import SMCDecodeConfig, smc_decode

    if torch.backends.cuda.matmul.allow_tf32:
        fail("path G: TF32 products are on; the JAX reference computes float32 products")
    mk, dev, drive, results, seed = ctx.mk, ctx.dev, ctx.drive, ctx.results, ctx.args.seed
    lap = time.perf_counter()

    def took(what):
        nonlocal lap
        print(f"time path G {what}: {time.perf_counter() - lap:.1f} s", flush=True)
        lap = time.perf_counter()

    arch = get_arch(DECODE_ARCH)
    cfg = dataclasses.replace(arch.model, dtype=torch.float32, remat=False)
    spec = MegopolisSpec(num_iters=DECODE_ITERS)
    print(f"path G: {DECODE_ARCH} ({arch.source}) at full width: {cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.num_params()} float32 parameters; "
          f"N = {DECODE_N}, prompt {DECODE_PROMPT}, {DECODE_TOKENS} new tokens, {spec}",
          flush=True)

    # -- G1: serve_once as a user calls it, timed ---------------------------------
    torch.cuda.reset_peak_memory_stats()
    out = drive("decode/g1_serve_once@int32", lambda: serve_once(
        DECODE_ARCH, smoke=False, num_particles=DECODE_N, prompt_len=DECODE_PROMPT,
        new_tokens=DECODE_TOKENS, resampler=spec, seed=seed, target_temp=DECODE_TARGET_TEMP),
        [mk.megopolis_step])
    tokens, log_w = out["tokens"], out["log_weights"]
    launches = results["decode/g1_serve_once@int32"]["launches"]
    g1_rec = {k: out[k] for k in ("prefill_s", "decode_s", "tok_per_s", "num_resamples",
                                  "final_ess")}
    g1_rec.update(launches=launches,
                  max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                  tokens_shape=list(tokens.shape), tokens_dtype=str(tokens.dtype))
    results["decode/g1_serve_once@int32"].update(g1_rec)
    print(f"path G1: {json.dumps(g1_rec, default=float)}", flush=True)
    if launches != {"megopolis_step": DECODE_TOKENS}:
        fail(f"G1: expected one megopolis_step launch a token, {DECODE_TOKENS}; got {launches}")
    if out["num_resamples"] < 1:
        fail("G1: the resample branch never fired")
    if tokens.shape != (DECODE_N, DECODE_TOKENS) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        fail(f"G1: tokens {list(tokens.shape)} out of [0, {cfg.vocab_size})")
    if not bool(torch.isfinite(log_w).all()):
        fail("G1: a log-weight is not finite")
    took("G1")

    # -- G2: the same decode, profiled, split into its parts -----------------------
    params, prompts, k_decode = decode_inputs(cfg, DECODE_N, DECODE_PROMPT, seed, dev)
    max_seq = DECODE_PROMPT + DECODE_TOKENS
    smc_cfg = SMCDecodeConfig(num_particles=DECODE_N, max_new_tokens=DECODE_TOKENS,
                              resampler=spec, target_temp=DECODE_TARGET_TEMP)
    _, caches = prefill(params, cfg, prompts, max_seq)
    labels, box = [], {}
    with decode_parts(labels):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            box["out"] = drive("decode/g2_profiled@int32", lambda: smc_decode(
                params, cfg, smc_cfg, caches, prompts[:, -1], DECODE_PROMPT, k_decode),
                [mk.megopolis_step])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    del caches
    g2 = decode_breakdown(prof, labels, wall, DECODE_TOKENS)
    del prof
    g2["tokens_equal_g1"] = bool(torch.equal(box["out"][0], tokens))
    results["decode/g2_profiled@int32"].update(g2)
    print(f"path G2: {json.dumps(g2, default=float)}", flush=True)
    if g2["port_launches_per_step"] > 1:
        fail(f"G2: {g2['port_launches_per_step']} port kernel launches a step, not one")
    took("G2")

    # -- G3: the same decode, untimed, the step kernel on its last resampling call --
    _, caches = prefill(params, cfg, prompts, max_seq)
    step_args = capture(mops, "megopolis_step", lambda: box.update(g3=smc_decode(
        params, cfg, smc_cfg, caches, prompts[:, -1], DECODE_PROMPT, k_decode)))
    del caches
    if not torch.equal(box.pop("g3")[0], tokens):
        fail("G3: the captured decode's tokens differ from G1's")
    lw3, st3, o3, s3, thr3 = step_args
    if st3.dtype != torch.int32 or st3.shape != (DECODE_TOKENS, DECODE_N):
        fail(f"G3: the captured state is {st3.dtype}{list(st3.shape)}, not the token buffer")
    held = check_kernel(("megopolis_step@int32/g3", mk.megopolis_step, step_args,
                         lambda: mref.megopolis_step_rows_ref(lw3[None], st3[None], o3[None],
                                                              s3.reshape(1), thr3),
                         "megopolis", "step", 1, o3.shape[-1]), timed=False)
    results["decode/g3_held"] = held
    took("G3")

    # -- G4: one prompt for every particle, near-greedy: equal continuations --------
    same = torch.tensor([COHERENCE_PROMPT], dtype=torch.int32, device=dev).expand(
        DECODE_N, len(COHERENCE_PROMPT)).contiguous()
    _, caches = prefill(params, cfg, same, len(COHERENCE_PROMPT) + COHERENCE_TOKENS)
    smc4 = SMCDecodeConfig(num_particles=DECODE_N, max_new_tokens=COHERENCE_TOKENS,
                           resampler=spec, proposal_temp=COHERENCE_TEMP,
                           target_temp=COHERENCE_TEMP)
    tok4, _, _ = drive("decode/g4_coherence@int32", lambda: smc_decode(
        params, cfg, smc4, caches, same[:, -1], len(COHERENCE_PROMPT),
        trandom.fold_in(k_decode, 5)), [mk.megopolis_step])
    del caches, params
    differ = int((tok4 != tok4[0]).any(dim=1).sum())
    results["decode/g4_coherence@int32"].update(particles_differing=differ,
                                                 continuation=tok4[0].tolist())
    print(f"path G4: {differ} of {DECODE_N} continuations differ from particle 0's "
          f"{tok4[0].tolist()}", flush=True)
    if differ:
        fail(f"G4: {differ} particles' continuations differ under one prompt")
    took("G4")

    # -- G5: the smoke config, card against CPU, from the same params --------------
    scfg = dataclasses.replace(arch.smoke, dtype=torch.float32, remat=False)
    cpu_params, cpu_prompts, k5 = decode_inputs(scfg, DECODE_N, DECODE_PROMPT, seed, "cpu")
    card_params = _map_tree(lambda leaf: leaf.to(dev), cpu_params)
    logits_cpu, caches_cpu = prefill(cpu_params, scfg, cpu_prompts, max_seq)
    logits_card, caches_card = prefill(card_params, scfg, cpu_prompts.to(dev), max_seq)
    err = float((logits_card.cpu() - logits_cpu).abs().max())
    step5 = capture(mops, "megopolis_step", lambda: drive(
        "decode/g5_smoke@int32", lambda: box.update(card=smc_decode(
            card_params, scfg, smc_cfg, caches_card, cpu_prompts[:, -1].to(dev), DECODE_PROMPT,
            k5)), [mk.megopolis_step]))
    got = mk.megopolis_step(*step5)
    lw5, st5, o5, s5, thr5 = step5
    want = mref.megopolis_step_rows_ref(lw5.cpu()[None], st5.cpu()[None], o5.cpu()[None],
                                        s5.cpu().reshape(1), thr5)
    anc_mismatch = int((got[0].cpu() != want[0][0]).sum())
    tokens_same = bool(torch.equal(got[1].cpu(), want[1][0]))
    cpu_tokens = smc_decode(cpu_params, scfg, smc_cfg, caches_cpu, cpu_prompts[:, -1],
                            DECODE_PROMPT, k5)[0]
    g5 = {"prefill_logits_max_abs_err": err, "atol": DECODE_CPU_ATOL,
          "step_ancestor_mismatches": anc_mismatch, "step_tokens_equal": tokens_same,
          "decode_tokens_equal_share": float((box["card"][0].cpu() == cpu_tokens).float().mean())}
    results["decode/g5_smoke@int32"].update(g5)
    print(f"path G5: {json.dumps(g5)}", flush=True)
    if err > DECODE_CPU_ATOL or anc_mismatch or not tokens_same:
        fail(f"G5: the card and the CPU differ: {g5}")
    took("G5")


def profiled_run(fn):
    """``fn()`` under ``contracts.record`` and the profiler: its result, its
    port-kernel census, the port's kernels among the profiler's events and
    the count of all its CUDA kernel events."""
    from repro_torch.analysis import contracts, smem

    prof_box = []

    @contextlib.contextmanager
    def profiled(rec):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            yield
            torch.cuda.synchronize()
            time.sleep(0.02)
        prof_box.append(prof)

    out, rec = contracts.record(fn, taint=False, around=profiled)
    names = [kernel_instance(name) for name, _ in device_kernels(prof_box[0])]
    seen = collections.Counter(k for k in names if k in smem.KERNELS)
    return out, dict(rec.census), dict(seen), len(names)


def path_d(args, dev, fam, bank_obs, thetas, k_run, families, drive, results):
    """Path D, the degeneracy guard (DESIGN.md §16) at full width: UNGM
    log-weights of a bank of S filters' first step at N particles, with row
    3 all -inf and row 11 holding one NaN, through each Path A family's
    ``step_rows`` at float32 and bfloat16 planes, at ``guard`` 'off',
    'recover' and 'flag' on the same keys and particles (threshold 0.5).
    'recover': the collapsed rows report ``degenerate``, ``ess_norm`` 1,
    ``log_evidence_incr`` 0 and finite state, the clean rows equal 'off''s
    bit for bit, and the port kernels launched equal 'off''s, held to the
    profiler; 'flag': 'off''s outputs bit for bit and exactly one
    ``guard_degenerate`` event naming the collapsed rows inside
    ``record_resilience_events``.  Prints the CUDA launches beyond the
    port's that 'recover' adds per step."""
    from repro_torch import random as trandom
    from repro_torch.core.metrics import log_weights_from_linear
    from repro_torch.resilience import record_resilience_events

    n, s = args.particles, args.bank
    rows = sorted({r % s for r in PATH_D_ROWS})
    clean = [i for i in range(s) if i not in rows]
    halves = trandom.split(trandom.split(trandom.fold_in(k_run, 11), s))
    th = {name: v.reshape(s, 1).to(dev) for name, v in thetas.items()}
    t = torch.tensor(1.0, device=dev)
    x = fam.transition(halves[:, 1], fam.init(halves[:, 0], n, dev), t, th)
    lw = log_weights_from_linear(fam.likelihood(bank_obs[:, :1].to(dev), x, t, th))
    lw[rows[0]] = float("-inf")
    if len(rows) > 1:
        lw[rows[1], 5] = float("nan")
    keys = trandom.split(trandom.fold_in(k_run, 12), s)

    def bits(out):
        p_out, anc, stats = out
        return [p_out.float().view(torch.int32), anc, *(f.float().view(torch.int32)
                                                        if f.dtype.is_floating_point else f
                                                        for f in stats)]

    for family, f in families.items():
        if f.get("plane", "float32") not in PATH_D_PLANES:
            continue
        t_family = time.perf_counter()
        base = f["spec"]
        runs = {}
        for guard in ("off", "recover"):
            r = base.replace(guard=guard).build()
            r.step_rows(keys, lw, x, THR)  # warm up
            name = f"path_d/{guard}/{family}"
            for attempt in (0, 1):
                out, census, seen, all_cuda = drive(
                    name, lambda: profiled_run(lambda: r.step_rows(keys, lw, x, THR)),
                    [f["bank_conditional"]])
                if census == seen:
                    break
                print(f"path_d {name}: the profiler saw {seen} for the census {census}; "
                      "driven again", flush=True)
            if any(seen.get(k, 0) != c for k, c in census.items()) or set(seen) - set(census):
                fail(f"{name}: census {census} and profiler {seen} differ")
            runs[guard] = (out, census, all_cuda)
            results[name].update(census=census, cuda_launches=all_cuda)
        (off, c_off, cuda_off), (rec, c_rec, cuda_rec) = runs["off"], runs["recover"]
        name = f"path_d/{family}"
        if c_rec != c_off:
            fail(f"{name}: 'recover' launched {c_rec}, 'off' {c_off}")
        p_rec, _, st = rec
        if not (st.degenerate[rows].all() and not st.degenerate[clean].any()
                and (st.ess_norm[rows] == 1.0).all() and (st.log_evidence_incr[rows] == 0).all()
                and bool(torch.isfinite(p_rec).all())):
            fail(f"{name}: the collapsed rows {rows} were not recovered: "
                 f"{summary(st)}, ess_norm {st.ess_norm[rows].tolist()}")
        for a, b in zip(bits(off), bits(rec)):
            if not torch.equal(a[clean], b[clean]):
                fail(f"{name}: 'recover' moved a clean row")
        r = base.replace(guard="flag").build()
        events = []
        with record_resilience_events(events):
            flag = drive(f"path_d/flag/{family}", lambda: r.step_rows(keys, lw, x, THR),
                         [f["bank_conditional"]])
        if not all(torch.equal(a, b) for a, b in zip(bits(off), bits(flag))):
            fail(f"{name}: 'flag' differs from 'off'")
        if [(e["kind"], e["degenerate_rows"], e["bank_rows"]) for e in events] != \
                [("guard_degenerate", len(rows), s)]:
            fail(f"{name}: 'flag' emitted {events}, not one event of {len(rows)} rows")
        results[name] = {"seconds": time.perf_counter() - t_family, "rows": rows,
                         "port_launches": sum(c_off.values()),
                         "recover_extra_cuda_launches_per_step": cuda_rec - cuda_off,
                         "degenerate": st.degenerate.tolist(), "flag_events": len(events),
                         "recovered": summary(st)}


def reference_inputs(key):
    """The reference comparison's weights on the CPU, one row and a bank."""
    from repro_torch.core.weightgen import gaussian_weights

    w = gaussian_weights(key, REFERENCE_N, REFERENCE_Y, device="cpu")
    return w, torch.stack([w, w.flip(0)])[:REFERENCE_ROWS].contiguous()


def reference_spec(name: str, backend: str):
    from repro_torch.core.spec import spec_for_backend

    return spec_for_backend(name, backend, num_iters=REFERENCE_ITERS,
                            max_iters=REFERENCE_MAX_ITERS)


def reference_on_cpu(key) -> dict:
    """Every family's reference ``r(key, w)`` and ``r.batch(key, w_bank)`` on
    the CPU: name -> (ancestors, bank ancestors, seconds)."""
    from repro_torch import random as trandom
    from repro_torch.core.spec import list_resamplers

    w, bank = reference_inputs(key)
    k_call = trandom.fold_in(key, 1)
    out = {}
    for name in list_resamplers():
        ref = reference_spec(name, "reference").build()
        t0 = time.perf_counter()
        out[name] = (ref(k_call, w), ref.batch(k_call, bank), time.perf_counter() - t0)
    return out


def reference_on_card(dev, key, on_cpu, drive, results):
    """The reference backend on the card: every family's ``r(key, w)`` and
    ``r.batch(key, w_bank)`` at ``REFERENCE_N`` particles on CUDA tensors,
    bit for bit with the same calls on the CPU (``on_cpu``:
    ``reference_on_cpu``'s), timed beside the ``cuda`` backend's same calls
    (``spec_for_backend``'s geometry at B = ``REFERENCE_ITERS``; eq. (12)
    weights at y = ``REFERENCE_Y``)."""
    from repro_torch import random as trandom
    from repro_torch.core.spec import list_resamplers

    w_cpu, bank_cpu = reference_inputs(key)
    w, bank = w_cpu.to(dev), bank_cpu.to(dev)
    k_call = trandom.fold_in(key, 1)
    for name in list_resamplers():
        ref, cuda = reference_spec(name, "reference").build(), reference_spec(name, "cuda").build()
        got, got_b = drive(f"reference/{name}", lambda: (ref(k_call, w), ref.batch(k_call, bank)),
                           [])
        if results[f"reference/{name}"]["launches"]:
            fail(f"reference/{name}: the reference backend launched port kernels")
        want, want_b, cpu_s = on_cpu[name]
        if not (torch.equal(got.cpu(), want) and torch.equal(got_b.cpu(), want_b)):
            fail(f"reference/{name}: the card's ancestors differ from the CPU's "
                 f"({int((got.cpu() != want).sum())} of {REFERENCE_N})")
        results[f"reference/{name}"].update(
            n=REFERENCE_N, rows=REFERENCE_ROWS, bit_equal_with_cpu=True, cpu_s=cpu_s,
            reference_ms=time_ms(lambda: ref(k_call, w), 3, warmup=1),
            cuda_ms=time_ms(lambda: cuda(k_call, w), 10, warmup=2),
            reference_batch_ms=time_ms(lambda: ref.batch(k_call, bank), 2, warmup=1),
            cuda_batch_ms=time_ms(lambda: cuda.batch(k_call, bank), 10, warmup=2))


def path_a(family, f, args, dev, model, fam, obs, truth, bank_obs, bank_truth, thetas, k_run,
           drive, results):
    """Path A for one family: the filter runs of Table 2 at full width."""
    from repro_torch.pf.filter import ParticleFilter, run_filter, run_filter_bank, run_filter_timed
    from repro_torch.pf.metrics import resample_ratio, rmse

    n, spec, s_bank = args.particles, f["spec"], args.bank
    # Warm up (CUDA context, allocator, kernel load) before anything is timed.
    for thr in (None, 0.5):
        run_filter(k_run, ParticleFilter(model, n, resampler=spec, ess_threshold=thr),
                   obs[:3], device=dev)
        run_filter_bank(k_run, ParticleFilter(fam, n, resampler=spec, ess_threshold=thr),
                        bank_obs[:, :2], thetas, device=dev)
    for mode, thr in (("alg6", None), ("conditional", 0.5)):
        pf = ParticleFilter(model, n, resampler=spec, ess_threshold=thr)
        name = f"run_filter/{mode}/{family}"
        ests, tel = drive(name, lambda: run_filter(k_run, pf, obs, telemetry=True, device=dev),
                          [f[mode]], args.steps)
        if ests.shape != (args.steps,) or not torch.isfinite(ests).all():
            fail(f"{name}: estimates not finite of shape ({args.steps},)")
        results[name].update(rmse=rmse(ests.cpu().numpy(), truth.cpu().numpy()),
                             stats=summary(tel.steps))
    steps = min(args.bank_steps, PATH_A_BANK_STEPS)
    if steps < args.bank_steps:
        print(f"cut run_filter_bank/*/{family}: {steps} of {args.bank_steps} bank steps "
              "(the whole run's time; what it saves is printed after Path A)", flush=True)
    first = steps

    def rmse_mean(ests, t):
        return sum(rmse(ests[i, :t].cpu().numpy(), bank_truth[i, :t].cpu().numpy())
                   for i in range(s_bank)) / s_bank

    for mode, thr in (("alg6", None), ("conditional", 0.5)):
        pf = ParticleFilter(fam, n, resampler=spec, ess_threshold=thr)
        name = f"run_filter_bank/{mode}/{family}"
        ests, tel = drive(
            name, lambda: run_filter_bank(k_run, pf, bank_obs[:, :steps], thetas,
                                          telemetry=True, device=dev),
            [f[f"bank_{mode}"]], steps)
        if ests.shape != (s_bank, steps) or not torch.isfinite(ests).all():
            fail(f"{name}: estimates not finite of shape ({s_bank}, {steps})")
        results[name].update(rmse_mean=rmse_mean(ests, steps), stats=summary(tel.steps),
                             steps=steps, **{f"rmse_mean_first_{first}": rmse_mean(ests, first)})
    pf = ParticleFilter(model, n, resampler=spec)
    name = f"run_filter_timed/alg6/{family}"
    _, times = drive(name, lambda: run_filter_timed(k_run, pf, obs, device=dev), [f["alg6"]],
                     args.steps)
    results[name].update(resample_ratio=resample_ratio(times), times=times)


def path_a_index(family, f, args, dev, model, fam, obs, bank_obs, thetas, k_run, drive,
                 results):
    """The index-only entries of a family that Path B does not run, on Path
    A's weights: one population's and the bank's, captured from their last
    Alg. 6 step (``CAPTURE_STEPS`` steps) where they enter ``apply`` and
    ``apply_rows``; ``r(key, w)``, ``r.batch(key, w_bank)`` and
    ``r.batch_rows(keys, w_bank)``, each checked for ancestors in ``[0,
    N)``."""
    from repro_torch import random as trandom
    from repro_torch.pf.filter import ParticleFilter, run_filter, run_filter_bank

    n, spec = args.particles, f["spec"]
    pf = ParticleFilter(model, n, resampler=spec)
    w = capture_weights(lambda: run_filter(k_run, pf, obs[:CAPTURE_STEPS], device=dev), "apply")
    pf_bank = ParticleFilter(fam, n, resampler=spec)
    w_bank = capture_weights(lambda: run_filter_bank(
        k_run, pf_bank, bank_obs[:, :CAPTURE_STEPS], thetas, device=dev), "apply_rows")
    r = spec.build()
    key = trandom.fold_in(k_run, 7)
    keys = trandom.split(key, w_bank.shape[0])
    r(key, w)  # warm up
    name = f"path_a_index/{family}"
    anc, anc_b, anc_r = drive(
        name, lambda: (r(key, w), r.batch(key, w_bank), r.batch_rows(keys, w_bank)),
        [f["single"], f["batch"]])
    for got, shape in ((anc, (n,)), (anc_b, tuple(w_bank.shape)), (anc_r, tuple(w_bank.shape))):
        if tuple(got.shape) != shape or not bool(((got >= 0) & (got < n)).all()):
            fail(f"{name}: ancestors not in [0, N) of shape {shape}")
    results[name].update(rows=w_bank.shape[0], survivors=int(anc.unique().numel()))


def rejection_spread(spec, n, model, obs, k_run, dev) -> dict:
    """Rejection across a whole Alg. 6 run of Path A: per step, sup w / mean
    w (the mean rounds a lane needs; the telemetry's max_weight·N) and the
    device time of ``rejection_rows_kernel`` (profiler kernel events; it
    may drop a few), each as min, median, p90 and max over the steps."""
    from repro_torch.pf.filter import ParticleFilter, run_filter

    pf = ParticleFilter(model, n, resampler=spec)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)
        _, tel = run_filter(k_run, pf, obs, telemetry=True, device=dev)
        torch.cuda.synchronize()
    ms = sorted(us / 1e3 for name, us in device_kernels(prof) if "rejection_rows_kernel" in name)
    ratio = sorted((tel.steps.max_weight.float() * n).tolist())

    def spread(xs):
        return {"min": xs[0], "p50": xs[len(xs) // 2], "p90": xs[int(0.9 * len(xs))],
                "max": xs[-1]} if xs else {}

    return {"steps": len(ratio), "kernel_events": len(ms), "kernel_ms": spread(ms),
            "sup_over_mean_w": spread(ratio)}


def path_b(family, f, args, dev, k_quality, drive, results):
    """Path B for one family: Fig. 6's quality and speed study, index only,
    at N particles and K Monte Carlo resamples per y."""
    from repro_torch import random as trandom
    from repro_torch.core.iterations import gaussian_weight_iterations
    from repro_torch.core.metrics import bias_variance, offspring_counts
    from repro_torch.core.weightgen import gaussian_weights

    n, k = args.particles, args.runs
    for y in PATH_B_YS:
        b = gaussian_weight_iterations(y, 0.01)
        r = f["cls"](num_iters=b, plane_dtype=f.get("plane", "float32")).build()
        kw = trandom.fold_in(k_quality, int(y * 100))
        w = gaussian_weights(kw, n, y, device=dev)
        bank = w[None].expand(k, n).contiguous()
        keys = trandom.split(trandom.fold_in(kw, 1), k)
        k_time = trandom.fold_in(kw, 2)
        r.batch_rows(keys[:2], bank[:2])  # warm up
        name = f"fig6/y={y}/{family}"

        def run():
            off = offspring_counts(r.batch_rows(keys, bank), n)
            var, bias_sq, total = bias_variance(off, w)
            single_ms = time_ms(lambda: r(k_time, w), 10, warmup=1)
            batch_ms = time_ms(lambda: r.batch(k_time, bank), 3, warmup=1)
            return off, float(bias_sq), float(total), single_ms, batch_ms

        off, bias_sq, total, single_ms, batch_ms = drive(
            name, run, [f["batch_rows"], f["single"], f["batch"]])
        if off.shape != (k, n) or not bool((off.sum(dim=1) == n).all()):
            fail(f"{name}: offspring counts of shape {tuple(off.shape)} do not sum to N")
        if not (torch.isfinite(torch.tensor([bias_sq, total])).all() and 0 <= bias_sq <= total):
            fail(f"{name}: bias² {bias_sq} and MSE {total} not finite with bias² <= MSE")
        results[name].update(B=b, K=k, mse_over_n=total / n, bias_share=bias_sq / total,
                             single_ms=single_ms, batch_ms=batch_ms)


def path_b_gamma(args, dev, k_quality, drive, results, families):
    """Path B's Method 2 (paper eq. 13, Fig. 6's second weight family and
    Fig. 10's protocol): for each alpha, Gamma(alpha, 1) weights drawn on the
    card by ``gamma_weights`` (and the same draw on the CPU: the share of
    bit-equal samples), B from eq. (3) on them, and Path B's K Monte Carlo
    resamples, MSE/N, bias share and times for each family of Fig. 6's
    set."""
    from repro_torch import random as trandom
    from repro_torch.core.iterations import select_iterations
    from repro_torch.core.metrics import bias_variance, offspring_counts
    from repro_torch.core.weightgen import GAMMA_ALPHA_GRID, gamma_weights

    import concurrent.futures

    n, k = args.particles, args.runs
    keys_w = {alpha: trandom.fold_in(trandom.fold_in(k_quality, 13), int(alpha * 10))
              for alpha in GAMMA_ALPHA_GRID}

    def on_cpu(alpha):
        t0 = time.perf_counter()
        return gamma_weights(keys_w[alpha], n, alpha, device="cpu"), time.perf_counter() - t0

    # The CPU's draws run in a thread beside the card's work.
    pool = concurrent.futures.ThreadPoolExecutor(1)
    cpu_draws = {alpha: pool.submit(on_cpu, alpha) for alpha in GAMMA_ALPHA_GRID}
    for alpha in GAMMA_ALPHA_GRID:
        kw = keys_w[alpha]
        t0 = time.perf_counter()
        w = drive(f"fig6_gamma/alpha={alpha}/weights",
                  lambda: gamma_weights(kw, n, alpha, device=dev), [])
        card_s = time.perf_counter() - t0
        w_cpu, cpu_s = cpu_draws[alpha].result()
        if not (bool(torch.isfinite(w).all()) and bool((w >= 0).all())):
            fail(f"fig6_gamma/alpha={alpha}: weights not finite and non-negative")
        same = (w.cpu().view(torch.int32) == w_cpu.view(torch.int32)).double().mean().item()
        rel = ((w.cpu().double() - w_cpu.double()).abs() / w_cpu.double()).max().item()
        results[f"fig6_gamma/alpha={alpha}/weights"].update(
            card_vs_cpu_bit_equal_share=same, card_vs_cpu_max_rel=rel, card_s=card_s,
            cpu_s=cpu_s, mean=float(w.mean()), max=float(w.max()))
        b = select_iterations(w)
        bank = w[None].expand(k, n).contiguous()
        keys = trandom.split(trandom.fold_in(kw, 1), k)
        k_time = trandom.fold_in(kw, 2)
        for family, f in families.items():
            r = f["cls"](num_iters=b).build()
            r.batch_rows(keys[:2], bank[:2])  # warm up
            name = f"fig6_gamma/alpha={alpha}/{family}"

            def run():
                off = offspring_counts(r.batch_rows(keys, bank), n)
                _, bias_sq, total = bias_variance(off, w)
                return (off, float(bias_sq), float(total),
                        time_ms(lambda: r(k_time, w), 10, warmup=1),
                        time_ms(lambda: r.batch(k_time, bank), 3, warmup=1))

            off, bias_sq, total, single_ms, batch_ms = drive(
                name, run, [f["batch_rows"], f["single"], f["batch"]])
            if off.shape != (k, n) or not bool((off.sum(dim=1) == n).all()):
                fail(f"{name}: offspring counts of shape {tuple(off.shape)} do not sum to N")
            if not (math.isfinite(total) and 0 <= bias_sq <= total):
                fail(f"{name}: bias² {bias_sq} and MSE {total} not finite with bias² <= MSE")
            results[name].update(B=b, K=k, mse_over_n=total / n, bias_share=bias_sq / total,
                                 single_ms=single_ms, batch_ms=batch_ms)
    pool.shutdown()


def path_c(args, dev, key, drive, results, expected):
    """Path C, Fig. 8's study (``benchmarks/fig8_prefix_sum.py``): at each
    N of ``PATH_C_NS`` and y of ``PATH_B_YS``, Gaussian weights, K Monte
    Carlo resamples in one ``batch_rows`` call per method (Megopolis at B of
    eq. (3), the multinomial and improved systematic kinds, each of those
    also at bfloat16 planes), then MSE/N, the
    bias share, and the time of one ``r(key, w)`` (CUDA events, host work
    in).  Fig. 8 runs K = 256; this runs ``--runs``."""
    from repro_torch.core.iterations import gaussian_weight_iterations
    from repro_torch.core.metrics import bias_variance, offspring_counts
    from repro_torch.core.spec import MegopolisSpec, PrefixSumSpec

    k = args.runs
    for n in PATH_C_NS:
        for y in PATH_B_YS:
            b = gaussian_weight_iterations(y, 0.01)
            w, bank, keys, k_time = path_c_inputs(key, n, y, k, dev)
            for method in PATH_C_METHODS:
                kind, _, plane = method.partition("@")
                spec = (MegopolisSpec(num_iters=b) if method == "megopolis"
                        else PrefixSumSpec(kind=kind, plane_dtype=plane or "float32"))
                r = spec.build()
                r.batch_rows(keys[:2], bank[:2])  # warm up
                name = f"fig8/n={n}/y={y}/{method}"

                def run():
                    off = offspring_counts(r.batch_rows(keys, bank), n)
                    _, bias_sq, total = bias_variance(off, w)
                    return off, float(bias_sq), float(total), time_ms(lambda: r(k_time, w), 10,
                                                                       warmup=1)

                off, bias_sq, total, single_ms = drive(name, run, [expected[kind]])
                if off.shape != (k, n) or not bool((off.sum(dim=1) == n).all()):
                    fail(f"{name}: offspring counts of shape {tuple(off.shape)} do not sum to N")
                if not (torch.isfinite(torch.tensor([bias_sq, total])).all()
                        and 0 <= bias_sq <= total):
                    fail(f"{name}: bias² {bias_sq} and MSE {total} not finite with bias² <= MSE")
                results[name].update(B=b if method == "megopolis" else None, K=k,
                                     mse_over_n=total / n, bias_share=bias_sq / total,
                                     single_ms=single_ms)


def path_c_inputs(key, n, y, k, dev):
    """Path C's inputs at one (N, y) from its key: the weights, their bank of
    K rows, the K per-row keys and the key of the timed single call."""
    from repro_torch import random as trandom
    from repro_torch.core.weightgen import gaussian_weights

    kw = trandom.fold_in(trandom.fold_in(key, n), int(y * 10))
    w = gaussian_weights(kw, n, y, device=dev)
    bank = w[None].expand(k, n).contiguous()
    return w, bank, trandom.split(trandom.fold_in(kw, 1), k), trandom.fold_in(kw, 2)


def path_c_case(args, dev, k_quality):
    """``searchsorted_rows`` at Path C's largest bank, as ``kernel_cases``:
    the multinomial ``batch_rows`` call of ``path_c`` at N = 2^22, y = 4, K
    = ``--runs``, on its inputs (the row of the most launches x time)."""
    from repro_torch import random as trandom
    from repro_torch.core.spec import PrefixSumSpec
    from repro_torch.kernels.prefix_sum import ops as pops
    from repro_torch.kernels.prefix_sum import ref as pref
    from repro_torch.kernels.prefix_sum import search as sk

    _, bank, keys, _ = path_c_inputs(trandom.fold_in(k_quality, PATH_C_KEY), PATH_C_NS[-1],
                                     PATH_B_YS[-1], args.runs, dev)
    r = PrefixSumSpec(kind="multinomial").build()
    c, u, side, rising = capture(pops, "searchsorted_rows", lambda: r.batch_rows(keys, bank))
    del bank
    return ("searchsorted_rows/fig8", sk.searchsorted_rows, (c, u, side, rising),
            lambda: pref.search_rows_ref(c, u, side == "right"), "prefix", "search",
            c.shape[0], 1)


def small_runs(families, obs, truth, k_run, k_quality, dev) -> dict:
    """Both paths at a small size on the card against the same runs on the
    CPU (plain versions): the filter within ``SMALL_RUN_ATOL``, Path B's
    offspring bit for bit (the same weights on both; for rejection and the
    prefix-sum kinds, which Path B does not run, their index-only bank
    entry on the same weights).  The prefix-sum kinds resample through a
    CDF, which carries each weight's ULP (the card's noise and ``exp``
    against the CPU's) into every later draw, so a flipped ancestor is
    common and UNGM carries it on: their runs are held by the RMSE against
    the truth within the same bound, and each step of an Alg. 6 run on the
    CPU is replayed on the card (``replay_alg6``)."""
    from repro_torch import random as trandom
    from repro_torch.core.metrics import offspring_counts
    from repro_torch.core.spec import PrefixSumSpec
    from repro_torch.core.weightgen import gaussian_weights
    from repro_torch.pf.filter import ParticleFilter, run_filter
    from repro_torch.pf.metrics import rmse
    from repro_torch.pf.models import ungm

    out = {}
    for family, f in families.items():
        small = ParticleFilter(ungm(), 4096, resampler=f["small"], ess_threshold=0.5)
        on_card = run_filter(k_run, small, obs[:20], device=dev).cpu()
        on_cpu = run_filter(k_run, small, obs[:20].cpu(), device="cpu")
        step_err = float((on_card - on_cpu).abs().max())
        err = step_err
        out[family] = {"filter_max_abs": step_err}
        if isinstance(f["small"], PrefixSumSpec):
            ref = truth[:20].cpu().numpy()
            err = abs(rmse(on_card.numpy(), ref) - rmse(on_cpu.numpy(), ref))
            out[family]["alg6_steps_replayed_bit_equal"] = replay_alg6(f["small"], obs[:20],
                                                                       k_run, dev)
        if not err <= SMALL_RUN_ATOL:
            fail(f"small {family} filter: card and CPU differ by {err} > {SMALL_RUN_ATOL}")
        r = f["small"].build()
        w = gaussian_weights(k_quality, 8192, 2.0, device="cpu")
        keys = trandom.split(k_quality, 4)
        bank = w[None].expand(4, -1).contiguous()
        got = offspring_counts(r.batch_rows(keys, bank.to(dev)), 8192).cpu()
        if not torch.equal(got, offspring_counts(r.batch_rows(keys, bank), 8192)):
            fail(f"small {family} Fig. 6 run: card and CPU offspring differ")
        out[family].update(held=err, fig6_offspring_equal=True)
    return out


def replay_alg6(spec, obs, k_run, dev) -> int:
    """An Alg. 6 run at 4096 particles on the CPU (plain versions), each
    step's resample replayed on the card through ``apply`` on the CPU's key,
    weights and particles: the ancestors and the particles must be the same
    bits (the witness ``test_replay_alg6_bits`` gives the CPU against the
    JAX package).  Returns the steps replayed."""
    from repro_torch.core.spec import Resampler
    from repro_torch.pf.filter import ParticleFilter, run_filter
    from repro_torch.pf.models import ungm

    real = Resampler.apply
    calls = []

    def record(self, key, w, particles):
        result = real(self, key, w, particles)
        calls.append((key, w, particles, result))
        return result

    Resampler.apply = record
    try:
        run_filter(k_run, ParticleFilter(ungm(), 4096, resampler=spec), obs.cpu(),
                   device="cpu")
    finally:
        Resampler.apply = real
    r = spec.build()
    for t, (key, w, particles, (want_x, want_anc)) in enumerate(calls):
        got_x, got_anc = r.apply(key, w.to(dev), particles.to(dev))
        if not (torch.equal(got_anc.cpu(), want_anc)
                and torch.equal(got_x.cpu().view(torch.int32), want_x.view(torch.int32))):
            fail(f"small {spec.name} Alg. 6 replay: the card's step {t + 1} differs from the "
                 f"CPU's on the same inputs "
                 f"({int((got_anc.cpu() != want_anc).sum())} ancestors)")
    if len(calls) != obs.shape[0]:
        fail(f"small {spec.name} Alg. 6 replay: {len(calls)} resamples in {obs.shape[0]} steps")
    return len(calls)


def kernel_cases(args, dev, families, model, fam, obs, bank_obs, thetas, k_run,
                 k_quality, source=None) -> list:
    """Each wrapper's captured inputs, its plain version on them, and what
    its bound needs: ``(name, wrapper, inputs, plain, family, kind, rows,
    iters)``; with ``source`` (a ``SOURCES`` value) only the cases of the
    kernels built from it."""
    from repro_torch import random as trandom
    from repro_torch.core.iterations import gaussian_weight_iterations
    from repro_torch.core.spec import PrefixSumSpec
    from repro_torch.core.weightgen import gaussian_weights
    from repro_torch.kernels.common import key_to_seed
    from repro_torch.kernels.megopolis import megopolis as mk
    from repro_torch.kernels.megopolis import ops as mops
    from repro_torch.kernels.megopolis import ref as mref
    from repro_torch.kernels.metropolis import metropolis as tk
    from repro_torch.kernels.metropolis import ops as tops
    from repro_torch.kernels.metropolis import ref as tref
    from repro_torch.kernels.rejection import ref as rref
    from repro_torch.kernels.rejection import rejection as rk
    from repro_torch.pf.filter import ParticleFilter, run_filter, run_filter_bank

    n = args.particles

    def spec_of(family):
        return families[family]["spec"] if family in families else PrefixSumSpec(kind=family)

    def single(family, thr):
        pf = ParticleFilter(model, n, resampler=spec_of(family), ess_threshold=thr)
        return lambda: run_filter(k_run, pf, obs[:CAPTURE_STEPS], device=dev)

    def bank(family, thr):
        pf = ParticleFilter(fam, n, resampler=spec_of(family), ess_threshold=thr)
        return lambda: run_filter_bank(k_run, pf, bank_obs[:, :CAPTURE_STEPS], thetas,
                                       device=dev)

    # Path B's largest shapes: y = 4 (B = 354), K resamples.
    y = PATH_B_YS[-1]
    kw = trandom.fold_in(k_quality, int(y * 100))
    w_b = gaussian_weights(kw, n, y, device=dev)
    bank_b = w_b[None].expand(args.runs, n).contiguous()
    keys_b = trandom.split(trandom.fold_in(kw, 1), args.runs)
    k_time = trandom.fold_in(kw, 2)
    b_y = gaussian_weight_iterations(y, 0.01)

    def fig6(family, entry):
        r = families[family]["cls"](num_iters=b_y).build()
        if entry == "batch_rows":
            return lambda: r.batch_rows(keys_b, bank_b)
        if entry == "batch":
            return lambda: r.batch(k_time, bank_b)
        return lambda: r(k_time, w_b)

    def keep(family):
        return source is None or SOURCES[family] == source

    cases = []
    if keep("megopolis"):
        cases += megopolis_cases(mk, mops, mref, fig6, single, bank)
        cases.append(decode_step_case(mk, mops, mref, dev, args.seed))
    if keep("metropolis"):
        cases += metropolis_cases(tk, tops, tref, fig6, single, bank)
    # Metropolis-C1/C2, rows 13-18 (and their bank forms on the same kernels).
    for variant in (1, 2):
        c = f"metropolis_c{variant}"
        if keep(c):
            cases += c1c2_cases(c, variant, tops, fig6(c, "single"), fig6(c, "batch_rows"),
                                single(c, None), bank(c, None), single(c, THR), bank(c, THR),
                                THR)
    if keep("rejection"):
        # Rejection, rows 19-24: the index-only wrappers on Path A's weights.
        cases += rejection_cases(families["rejection"]["spec"], single("rejection", None),
                                 bank("rejection", None), single("rejection", THR),
                                 bank("rejection", THR), THR, k_run)
        # Rejection where its cap binds: eq. (12) weights at y = 4.
        k_cap = trandom.fold_in(k_quality, 400)
        w_cap = gaussian_weights(k_cap, n, 4.0, device=dev)
        sd_cap, it_cap = key_to_seed(trandom.fold_in(k_cap, 1)), REJECTION_CAP_CASE_ITERS
        cases.append(("rejection_cap", rk.rejection, (w_cap, sd_cap, it_cap),
                      lambda: rref.rejection_rows_ref(w_cap[None], None, sd_cap.reshape(1),
                                                      it_cap),
                      "rejection", "index", 1, it_cap))
    if keep("prefix"):
        # The prefix-sum kinds, rows 25-29, and Path C's largest bank.
        cases += prefix_cases(single, bank, THR, k_run)
        cases.append(path_c_case(args, dev, k_quality))
    if keep("reduce"):
        cases += reduce_cases(args, dev, k_quality)
    return cases


def reduce_cases(args, dev, k_quality) -> list:
    """``logsumexp_rows`` (no TPU counterpart) on Path E's E3 inputs: a
    two-temperature run of E3's bank (adaptive MALA, AIS_E3_BANK rows of N
    particles, E3's key), whose second temperature's first reduction (the
    normalisation, ``[S, N]``) is the listed case and its second (a CESS
    round's two sums, ``[2·S, N]``) a case held and printed beside it; and
    the same two of E3's single run (``/single``: row AIS_E3_ROW, ``[1,
    N]``; ``/single_cess``: its two sums, rows AIS_E3_ROW and S +
    AIS_E3_ROW, ``[2, N]``), which reduces those very rows: E3 holds its
    every leaf to the bank row's."""
    from repro_torch import random as trandom
    from repro_torch.ais import SMCSamplerConfig, gaussian_mixture, run_smc_sampler_bank
    from repro_torch.ais.schedule import ADAPTIVE_LAUNCHES
    from repro_torch.core.spec import spec_for_backend
    from repro_torch.kernels.reduce import ops as lops
    from repro_torch.kernels.reduce import ref as lref

    cfg = SMCSamplerConfig(num_particles=args.particles, num_temps=2, schedule="adaptive",
                           move="mala", resampler=spec_for_backend(
                               "megopolis", "cuda", num_iters=AIS_ITERS))
    k3 = trandom.fold_in(trandom.fold_in(k_quality, AIS_KEY), 3)
    real, seen, calls = lops.logsumexp_rows, [0], {}

    def record(x):
        if seen[0] in (ADAPTIVE_LAUNCHES, ADAPTIVE_LAUNCHES + 1):
            calls[seen[0] - ADAPTIVE_LAUNCHES] = x.clone()
        seen[0] += 1
        return real(x)

    lops.logsumexp_rows = record
    try:
        run_smc_sampler_bank(k3, gaussian_mixture(device=dev), cfg, num_scenarios=AIS_E3_BANK,
                             device=dev)
    finally:
        lops.logsumexp_rows = real
    r = AIS_E3_ROW
    xs = {"logsumexp_rows": calls[0], "logsumexp_rows/cess": calls[1],
          "logsumexp_rows/single": calls[0][r:r + 1].contiguous(),
          "logsumexp_rows/single_cess": calls[1][[r, AIS_E3_BANK + r]].contiguous()}
    return [(name, real, (x,), lambda x=x: lref.logsumexp_rows_ref(x), "reduce", "lse",
             x.shape[0], 1) for name, x in xs.items()]


#: The plane dtypes phase 4 holds the kernels of rows 1-29 at: the suffix of
#: a case's name and the dtype its captured weights, log-weights and state
#: are narrowed to, as a compressed spec narrows them (the prefix-sum
#: kernels' CDFs and draws stay float32: ``PREFIX_NARROWED``).
PLANES = (("", torch.float32), ("@bfloat16", torch.bfloat16), ("@float16", torch.float16))


def narrow(dt, *xs) -> tuple:
    """The float tensors of ``xs`` in the plane dtype ``dt``, others as they are."""
    return tuple(x.to(dt) if torch.is_tensor(x) and x.is_floating_point() else x for x in xs)


def megopolis_cases(mk, mops, mref, fig6, single, bank) -> list:
    """Rows 1-6 on captured inputs, as ``kernel_cases``, at each plane dtype
    of ``PLANES``."""
    cases = []
    captured = (capture(mops, "megopolis", fig6("megopolis", "single")),
                capture(mops, "megopolis_batch", fig6("megopolis", "batch")),
                capture(mops, "megopolis_rows", fig6("megopolis", "batch_rows")),
                capture(mops, "megopolis_fused", single("megopolis", None)),
                capture(mops, "megopolis_fused_rows", bank("megopolis", None)),
                capture(mops, "megopolis_step", single("megopolis", THR)),
                capture(mops, "megopolis_step_rows", bank("megopolis", THR)))
    for sfx, dt in PLANES:
        (w, offs, seed), (wb, offs_b, seeds_b), (wr, offs_r, seeds_r), (w1, st1, o1, s1), \
            (w2, st2, o2, s2), (l3, st3, o3, s3, _), (l4, st4, o4, s4, _) = (
                narrow(dt, *args) for args in captured)
        cases += [
            (f"megopolis{sfx}", mk.megopolis, (w, offs, seed),
             lambda w=w, offs=offs, seed=seed: mref.megopolis_rows_ref(
                 w[None], offs[None], seed.reshape(1)),
             "megopolis", "index", 1, offs.shape[-1]),
            (f"megopolis_batch{sfx}", mk.megopolis_batch, (wb, offs_b, seeds_b),
             lambda wb=wb, offs_b=offs_b, seeds_b=seeds_b: mref.megopolis_rows_ref(
                 wb, offs_b[None].expand(wb.shape[0], -1), seeds_b),
             "megopolis", "index", wb.shape[0], offs_b.shape[-1]),
            (f"megopolis_rows{sfx}", mk.megopolis_rows, (wr, offs_r, seeds_r),
             lambda wr=wr, offs_r=offs_r, seeds_r=seeds_r: mref.megopolis_rows_ref(
                 wr, offs_r, seeds_r),
             "megopolis", "index", wr.shape[0], offs_r.shape[-1]),
            (f"megopolis_fused{sfx}", mk.megopolis_fused, (w1, st1, o1, s1),
             lambda w1=w1, st1=st1, o1=o1, s1=s1: mref.megopolis_fused_rows_ref(
                 w1[None], st1[None], o1[None], s1.reshape(1)),
             "megopolis", "fused", 1, o1.shape[-1]),
            (f"megopolis_fused_rows{sfx}", mk.megopolis_fused_rows, (w2, st2, o2, s2),
             lambda w2=w2, st2=st2, o2=o2, s2=s2: mref.megopolis_fused_rows_ref(
                 w2, st2, o2, s2),
             "megopolis", "fused", w2.shape[0], o2.shape[-1]),
            (f"megopolis_step{sfx}", mk.megopolis_step, (l3, st3, o3, s3, THR),
             lambda l3=l3, st3=st3, o3=o3, s3=s3: mref.megopolis_step_rows_ref(
                 l3[None], st3[None], o3[None], s3.reshape(1), THR),
             "megopolis", "step", 1, o3.shape[-1]),
            (f"megopolis_step_rows{sfx}", mk.megopolis_step_rows, (l4, st4, o4, s4, THR),
             lambda l4=l4, st4=st4, o4=o4, s4=s4: mref.megopolis_step_rows_ref(
                 l4, st4, o4, s4, THR),
             "megopolis", "step", l4.shape[0], o4.shape[-1]),
        ]
    return cases


def decode_step_case(mk, mops, mref, dev, seed) -> tuple:
    """Row 5 on SMC decoding's state (``megopolis_step@int32``): the last
    resampling call of a decode of DECODE_TOKENS tokens at DECODE_N
    particles on the qwen3 smoke config (Path G's spec, temperature and
    threshold), whose state is the token buffer ``int32[T, N]``; Path G
    drives the same kernel at full width."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core.spec import MegopolisSpec
    from repro_torch.models import prefill
    from repro_torch.smc import SMCDecodeConfig, smc_decode

    cfg = dataclasses.replace(get_arch(DECODE_ARCH).smoke, dtype=torch.float32, remat=False)
    params, prompts, k_decode = decode_inputs(cfg, DECODE_N, DECODE_PROMPT, seed, dev)
    smc_cfg = SMCDecodeConfig(num_particles=DECODE_N, max_new_tokens=DECODE_TOKENS,
                              resampler=MegopolisSpec(num_iters=DECODE_ITERS),
                              target_temp=DECODE_TARGET_TEMP)

    def run():
        _, caches = prefill(params, cfg, prompts, DECODE_PROMPT + DECODE_TOKENS)
        smc_decode(params, cfg, smc_cfg, caches, prompts[:, -1], DECODE_PROMPT, k_decode)

    lw, st, o, s, thr = capture(mops, "megopolis_step", run)
    return ("megopolis_step@int32", mk.megopolis_step, (lw, st, o, s, thr),
            lambda: mref.megopolis_step_rows_ref(lw[None], st[None], o[None], s.reshape(1), thr),
            "megopolis", "step", 1, o.shape[-1])


def metropolis_cases(tk, tops, tref, fig6, single, bank) -> list:
    """Rows 7-12 on captured inputs, as ``kernel_cases``, at each plane dtype
    of ``PLANES``."""
    cases = []
    captured = (capture(tops, "metropolis", fig6("metropolis", "single")),
                capture(tops, "metropolis_batch", fig6("metropolis", "batch_rows")),
                capture(tops, "metropolis_fused", single("metropolis", None)),
                capture(tops, "metropolis_fused_batch", bank("metropolis", None)),
                capture(tops, "metropolis_step", single("metropolis", THR)),
                capture(tops, "metropolis_step_rows", bank("metropolis", THR)))
    for sfx, dt in PLANES:
        (v, sd, it), (vb, sdb, itb), (v1, t1, sd1, it1), (v2, t2, sd2, it2), \
            (lv3, t3, sd3, it3, _), (lv4, t4, sd4, it4, _) = (
                narrow(dt, *args) for args in captured)
        cases += [
            (f"metropolis{sfx}", tk.metropolis, (v, sd, it),
             lambda v=v, sd=sd, it=it: tref.metropolis_rows_ref(v[None], None, sd.reshape(1), it),
             "metropolis", "index", 1, it),
            (f"metropolis_batch{sfx}", tk.metropolis_batch, (vb, sdb, itb),
             lambda vb=vb, sdb=sdb, itb=itb: tref.metropolis_rows_ref(vb, None, sdb, itb),
             "metropolis", "index", vb.shape[0], itb),
            (f"metropolis_fused{sfx}", tk.metropolis_fused, (v1, t1, sd1, it1),
             lambda v1=v1, t1=t1, sd1=sd1, it1=it1: tref.metropolis_rows_ref(
                 v1[None], t1[None], sd1.reshape(1), it1),
             "metropolis", "fused", 1, it1),
            (f"metropolis_fused_batch{sfx}", tk.metropolis_fused_batch, (v2, t2, sd2, it2),
             lambda v2=v2, t2=t2, sd2=sd2, it2=it2: tref.metropolis_rows_ref(v2, t2, sd2, it2),
             "metropolis", "fused", v2.shape[0], it2),
            (f"metropolis_step{sfx}", tk.metropolis_step, (lv3, t3, sd3, it3, THR),
             lambda lv3=lv3, t3=t3, sd3=sd3, it3=it3: tref.metropolis_step_rows_ref(
                 lv3[None], t3[None], sd3.reshape(1), it3, THR),
             "metropolis", "step", 1, it3),
            (f"metropolis_step_rows{sfx}", tk.metropolis_step_rows, (lv4, t4, sd4, it4, THR),
             lambda lv4=lv4, t4=t4, sd4=sd4, it4=it4: tref.metropolis_step_rows_ref(
                 lv4, t4, sd4, it4, THR),
             "metropolis", "step", lv4.shape[0], it4),
        ]
    return cases


def rejection_cases(spec, alg6, bank_alg6, cond, bank_cond, thr, key) -> list:
    """The six rejection wrappers on captured inputs, as ``kernel_cases``,
    at each plane dtype of ``PLANES``: the fused and step wrappers from Path
    A's runs, the index-only ones from ``r(key, w)``, ``r.batch_rows(keys,
    w_bank)`` on the weights those runs captured; the plain version of each
    is the bank form on the same arguments."""
    from repro_torch import random as trandom
    from repro_torch.kernels.rejection import ops as rops
    from repro_torch.kernels.rejection import ref as rref
    from repro_torch.kernels.rejection import rejection as rk

    fused = capture(rops, "rejection_fused", alg6)
    fused_b = capture(rops, "rejection_fused_batch", bank_alg6)
    r = spec.build()
    k = trandom.fold_in(key, 7)
    keys = trandom.split(k, fused_b[0].shape[0])
    captured = (capture(rops, "rejection", lambda: r(k, fused[0])),
                capture(rops, "rejection_batch", lambda: r.batch_rows(keys, fused_b[0])),
                fused, fused_b, capture(rops, "rejection_step", cond),
                capture(rops, "rejection_step_rows", bank_cond))
    cases = []
    for sfx, dt in PLANES:
        (w, sd, it), (wb, sdb, itb), (w1, t1, sd1, it1), (w2, t2, sd2, it2), \
            (l3, t3, sd3, it3, _), (l4, t4, sd4, it4, _) = (
                narrow(dt, *args) for args in captured)
        cases += [
            (f"rejection{sfx}", rk.rejection, (w, sd, it),
             lambda w=w, sd=sd, it=it: rref.rejection_rows_ref(w[None], None, sd.reshape(1),
                                                                it),
             "rejection", "index", 1, it),
            (f"rejection_batch{sfx}", rk.rejection_batch, (wb, sdb, itb),
             lambda wb=wb, sdb=sdb, itb=itb: rref.rejection_rows_ref(wb, None, sdb, itb),
             "rejection", "index", wb.shape[0], itb),
            (f"rejection_fused{sfx}", rk.rejection_fused, (w1, t1, sd1, it1),
             lambda w1=w1, t1=t1, sd1=sd1, it1=it1: rref.rejection_rows_ref(
                 w1[None], t1[None], sd1.reshape(1), it1),
             "rejection", "fused", 1, it1),
            (f"rejection_fused_batch{sfx}", rk.rejection_fused_batch, (w2, t2, sd2, it2),
             lambda w2=w2, t2=t2, sd2=sd2, it2=it2: rref.rejection_rows_ref(w2, t2, sd2, it2),
             "rejection", "fused", w2.shape[0], it2),
            (f"rejection_step{sfx}", rk.rejection_step, (l3, t3, sd3, it3, thr),
             lambda l3=l3, t3=t3, sd3=sd3, it3=it3: rref.rejection_step_rows_ref(
                 l3[None], t3[None], sd3.reshape(1), it3, thr),
             "rejection", "step", 1, it3),
            (f"rejection_step_rows{sfx}", rk.rejection_step_rows, (l4, t4, sd4, it4, thr),
             lambda l4=l4, t4=t4, sd4=sd4, it4=it4: rref.rejection_step_rows_ref(
                 l4, t4, sd4, it4, thr),
             "rejection", "step", l4.shape[0], it4),
        ]
    return cases


def prefix_cases(single, bank, thr, key) -> list:
    """The five prefix-sum wrappers on captured inputs, as ``kernel_cases``:
    on a bank, the scan and the gather from Path A's multinomial bank run,
    ``searchsorted_rows`` from a stratified ``r.batch_rows(keys, w_bank)``
    on the weights that run captured, the select from residual's and the
    step from residual's bank run.  More cases, not in the ``kernels``
    line, hold the wrappers on one population (a bank of one row: the scan
    and the step from multinomial's single run, the search from a
    systematic ``r(key, w)``, the gather from improved systematic's run and
    from multinomial's, the select and the step from residual's, the step
    from systematic's and stratified's) and the step's improved systematic,
    multinomial and stratified instances on a bank.  At each 2-byte dtype
    of ``PLANES``, the bank cases again with what the compressed path
    narrows narrowed (``PREFIX_NARROWED``: the scan's input, the searches'
    state, the step's log-weights and state; the CDFs and draws stay
    float32), the index-only search on the CDF and draws of a compressed
    spec's ``batch_rows``."""
    from repro_torch import random as trandom
    from repro_torch.core.spec import PrefixSumSpec
    from repro_torch.kernels.prefix_sum import ops as pops
    from repro_torch.kernels.prefix_sum import prefix_sum as pk
    from repro_torch.kernels.prefix_sum import ref as pref
    from repro_torch.kernels.prefix_sum import search as sk
    from repro_torch.kernels.prefix_sum import step as stk

    # Each case kind's wrapper and plain version on its arguments.
    wrappers = {
        "scan": (pk.prefix_sum_rows, pref.scan_rows_ref),
        "search": (sk.searchsorted_rows,
                   lambda c, u, side, rising: pref.search_rows_ref(c, u, side == "right")),
        "gather": (sk.searchsorted_gather_rows,
                   lambda c, u, t, side, rising: pref.search_rows_ref(c, u, side == "right", t)),
        "residual": (sk.residual_select_gather_rows, pref.residual_select_rows_ref),
        "step": (stk.prefix_step_rows, pref.prefix_step_rows_ref),
    }

    def case(name, kind, kargs):
        wrapper, plain = wrappers[kind]
        return (name, wrapper, kargs, lambda: plain(*kargs), "prefix", kind, kargs[0].shape[0],
                1)

    def captured(name, kind, run):
        return case(name, kind, capture(pops, wrappers[kind][0].__name__, run))

    # The scans' inputs are the weights of the last multinomial steps: the
    # searches run on them.
    scan_bank = captured("prefix_sum_rows", "scan", bank("multinomial", None))
    scan_one = captured("prefix_sum_rows/one", "scan", single("multinomial", None))
    w_bank, w_one = scan_bank[2][0], scan_one[2][0]
    k = trandom.fold_in(key, 9)
    keys = trandom.split(k, w_bank.shape[0])

    def stratified(dt="float32"):
        return lambda: PrefixSumSpec(kind="stratified", plane_dtype=dt).build().batch_rows(
            keys, w_bank)

    banks = [
        scan_bank,
        captured("searchsorted_rows", "search", stratified()),
        captured("searchsorted_gather_rows", "gather", bank("multinomial", None)),
        captured("residual_select_gather_rows", "residual", bank("residual", None)),
        captured("prefix_step_rows", "step", bank("residual", 0.5)),
        captured("prefix_step_rows/improved_systematic", "step", bank("improved_systematic", 0.5)),
        captured("prefix_step_rows/multinomial", "step", bank("multinomial", 0.5)),
        captured("prefix_step_rows/stratified", "step", bank("stratified", 0.5)),
    ]
    cases = banks[:5] + [
        scan_one,
        captured("searchsorted_rows/one", "search",
                 lambda: PrefixSumSpec(kind="systematic").build()(k, w_one[0])),
        captured("searchsorted_gather_rows/one", "gather", single("improved_systematic", None)),
        captured("searchsorted_gather_rows/one/multinomial", "gather",
                 single("multinomial", None)),
        captured("residual_select_gather_rows/one", "residual", single("residual", None)),
        captured("prefix_step_rows/one", "step", single("multinomial", 0.5)),
        captured("prefix_step_rows/one/residual", "step", single("residual", 0.5)),
        captured("prefix_step_rows/one/systematic", "step", single("systematic", 0.5)),
        captured("prefix_step_rows/one/stratified", "step", single("stratified", 0.5)),
    ] + banks[5:]
    for sfx, dt in PLANES[1:]:
        for name, _, kargs, _, _, kind, _, _ in banks:
            if kind == "search":
                cases.append(captured(name + sfx, kind, stratified(sfx[1:])))
                continue
            kargs = tuple(x.to(dt) if i in PREFIX_NARROWED[kind] else x
                          for i, x in enumerate(kargs))
            cases.append(case(name + sfx, kind, kargs))
    return cases


#: The arguments of each prefix-sum case kind a compressed spec narrows:
#: the scan's input, the gather's and the select's state, the step's
#: log-weights and state.
PREFIX_NARROWED = {"scan": (0,), "search": (), "gather": (2,), "residual": (4,),
                   "step": (0, 1)}


def c1c2_cases(c, variant, tops, fig6_single, fig6_rows, alg6, bank_alg6, cond, bank_cond,
               thr) -> list:
    """The six wrappers of one C1/C2 variant on captured inputs, as
    ``kernel_cases``, at each plane dtype of ``PLANES``: the plain version
    of each is the variant's bank form on the same arguments."""
    from repro_torch.kernels.metropolis import c1c2 as ck
    from repro_torch.kernels.metropolis import ref as tref

    def rows(w, st, parts, seeds, it):
        return lambda: tref.metropolis_c1c2_rows_ref(w, st, parts, seeds, it, variant)

    def steps(lw, st, parts, seeds, it):
        return lambda: tref.metropolis_c1c2_step_rows_ref(lw, st, parts, seeds, it, thr,
                                                          variant)

    captured = (capture(tops, c, fig6_single), capture(tops, f"{c}_batch", fig6_rows),
                capture(tops, f"{c}_fused", alg6), capture(tops, f"{c}_fused_batch", bank_alg6),
                capture(tops, f"{c}_step", cond), capture(tops, f"{c}_step_rows", bank_cond))
    cases = []
    for sfx, dt in PLANES:
        (w, p, sd, it), (wb, pb, sdb, itb), (w1, t1, p1, sd1, it1), (w2, t2, p2, sd2, it2), \
            (l3, t3, p3, sd3, it3, _), (l4, t4, p4, sd4, it4, _) = (
                narrow(dt, *args) for args in captured)
        cases += [
            (c + sfx, getattr(ck, c), (w, p, sd, it),
             rows(w[None], None, p[None], sd.reshape(1), it), c, "index", 1, it),
            (f"{c}_batch{sfx}", getattr(ck, f"{c}_batch"), (wb, pb, sdb, itb),
             rows(wb, None, pb, sdb, itb), c, "index", wb.shape[0], itb),
            (f"{c}_fused{sfx}", getattr(ck, f"{c}_fused"), (w1, t1, p1, sd1, it1),
             rows(w1[None], t1[None], p1[None], sd1.reshape(1), it1), c, "fused", 1, it1),
            (f"{c}_fused_batch{sfx}", getattr(ck, f"{c}_fused_batch"), (w2, t2, p2, sd2, it2),
             rows(w2, t2, p2, sd2, it2), c, "fused", w2.shape[0], it2),
            (f"{c}_step{sfx}", getattr(ck, f"{c}_step"), (l3, t3, p3, sd3, it3, thr),
             steps(l3[None], t3[None], p3[None], sd3.reshape(1), it3), c, "step", 1, it3),
            (f"{c}_step_rows{sfx}", getattr(ck, f"{c}_step_rows"), (l4, t4, p4, sd4, it4, thr),
             steps(l4, t4, p4, sd4, it4), c, "step", l4.shape[0], it4),
        ]
    return cases


#: The CUDA source of each family's kernels.
SOURCES = {"megopolis": "megopolis/csrc/megopolis.cu",
           "metropolis": "metropolis/csrc/metropolis.cu",
           "metropolis_c1": "metropolis/csrc/c1c2.cu", "metropolis_c2": "metropolis/csrc/c1c2.cu",
           "rejection": "rejection/csrc/rejection.cu", "prefix": "prefix_sum/csrc/prefix_sum.cu",
           "fixtures": "fixtures/csrc/fixtures.cu", "reduce": "reduce/csrc/reduce.cu"}
#: The port's kernels with no TPU counterpart: wrapper -> (the JAX package's
#: file and the call the kernel stands for, as ``replaces`` names them).
PORT_KERNELS = {"logsumexp_rows": ("src/repro/ais/schedule.py", "jax.nn.logsumexp(")}
#: The TPU kernel each wrapper replaces (``megopolis_rows`` is row 1 vmapped).
TPU_KERNELS = {
    "megopolis": "megopolis_pallas", "megopolis_batch": "megopolis_pallas_batch",
    "megopolis_rows": "megopolis_pallas", "megopolis_fused": "megopolis_pallas_fused",
    "megopolis_fused_rows": "megopolis_pallas_fused_rows",
    "megopolis_step": "megopolis_pallas_step", "megopolis_step_rows": "megopolis_pallas_step_rows",
    "metropolis": "metropolis_pallas", "metropolis_batch": "metropolis_pallas_batch",
    "metropolis_fused": "metropolis_pallas_fused",
    "metropolis_fused_batch": "metropolis_pallas_fused_batch",
    "metropolis_step": "metropolis_pallas_step",
    "metropolis_step_rows": "metropolis_pallas_step_rows",
    "rejection": "rejection_pallas", "rejection_batch": "rejection_pallas_batch",
    "rejection_fused": "rejection_pallas_fused",
    "rejection_fused_batch": "rejection_pallas_fused_batch",
    "rejection_step": "rejection_pallas_step", "rejection_step_rows": "rejection_pallas_step_rows",
    # The JAX package scans, searches and steps one population per call: the
    # bank forms replace the single kernel mapped over the rows.
    "prefix_sum_rows": "prefix_sum_pallas", "searchsorted_rows": "searchsorted_pallas",
    "searchsorted_gather_rows": "searchsorted_gather_pallas",
    "residual_select_gather_rows": "residual_select_gather_pallas",
    "prefix_step_rows": "prefix_pallas_step",
    # The contract checks' fixtures (``src/repro/analysis/fixtures.py``).
    "copy_launch": "_copy_launch", "iota_launch": "hbm_roundtrip",
}
for _c in ("metropolis_c1", "metropolis_c2"):
    # The JAX package has no C1/C2 bank kernel: the bank forms replace the
    # single kernel mapped over the rows.
    TPU_KERNELS.update({_c: f"{_c}_pallas", f"{_c}_batch": f"{_c}_pallas",
                        f"{_c}_fused": f"{_c}_pallas_fused",
                        f"{_c}_fused_batch": f"{_c}_pallas_fused",
                        f"{_c}_step": f"{_c}_pallas_step", f"{_c}_step_rows": f"{_c}_pallas_step"})


def bits(x: torch.Tensor) -> torch.Tensor:
    """The bits of a float tensor, as integers of its width."""
    return x.view({2: torch.int16, 4: torch.int32}[x.element_size()])


def prefix_work(kind, kargs, rows, n, fired) -> tuple:
    """Bytes a prefix-sum wrapper must move (each input read once, each
    output written once; the plane words at their width, the CDFs, draws
    and ancestors at 4 bytes) and its 32-bit operations, on its captured
    inputs, of which ``fired`` rows resample (a step's others keep their
    particles): ``(bytes, operations)``."""
    steps = max(1, math.ceil(math.log2(n + 1)))  # every lane bisects this or one less
    elems = rows * n
    if kind == "scan":  # the input words in, the CDF out
        return (kargs[0].element_size() + 4) * elems, SCAN_OPS * elems
    if kind == "search":  # CDF and draws in, ancestors out
        return 12 * elems, BISECT_OPS * steps * elems
    word = kargs[PREFIX_NARROWED[kind][-1]].element_size()  # the state's
    if kind == "gather":  # plus the state (D = 1) in and out
        return (12 + 2 * word) * elems, BISECT_OPS * steps * elems
    if kind == "residual":  # two CDFs, the draws, the state; ancestors and state out
        return (16 + 2 * word) * elems, BISECT_OPS * steps * elems
    # The step: every row's log-weights and state in, ancestors and state
    # out, and its prelude; a row that resamples also reads its draw bases
    # and runs the scans, the draws and the bisection.
    residual = kargs[-1] == "residual"
    drawn = fired * n
    base = 0 if kargs[2] is None else 4 * drawn
    scans = SCAN_OPS * (3 if residual else 1) + (RESIDUAL_SPLIT_OPS if residual else 0)
    return ((4 + 3 * word) * elems + base,
            PRELUDE_OPS * elems + (scans + DRAW_OPS + BISECT_OPS * steps) * drawn)


def library_call(kind, kargs):
    """One PyTorch call that computes the same function, on the same
    inputs, or None: ``torch.logsumexp`` for the row reduction,
    ``torch.cumsum`` for the scan, ``torch.searchsorted``
    for the search, and with the index of the state for the gather;
    ``Tensor.clone`` for the copy, ``torch.arange`` for the iota (timed
    beside the kernel only; the port never calls them)."""
    if kind == "copy":
        return kargs[0].clone
    if kind == "iota":
        n, dev = kargs[0].shape[0], kargs[0].device
        return lambda: torch.arange(n, dtype=torch.int32, device=dev)
    if kind == "scan":
        return lambda: torch.cumsum(kargs[0], dim=-1)
    if kind == "lse":
        return lambda: torch.logsumexp(kargs[0], dim=-1)
    if kind in ("search", "gather"):
        c, u, side = kargs[0], kargs[1], kargs[-2]
        if kind == "search":
            return lambda: torch.searchsorted(c, u, side=side)
        state = kargs[2]
        n = c.shape[-1]

        def search_and_index():
            k = torch.searchsorted(c, u, side=side).clamp_(max=n - 1)
            return torch.gather(state, -1, k.unsqueeze(-2).expand_as(state))
        return search_and_index
    return None


def gather_probe(seed: int, dev) -> dict:
    """The rate of random 4-byte reads from one row that L2 holds that one
    plain PyTorch gather reaches: ``w.index_select(0, idx)`` with
    ``PROBE_INDICES`` random ``int32`` indices over ``PROBE_N`` floats, made
    from ``seed``, timed by CUDA events (a yardstick beside the Metropolis
    kernels; the port never calls it).  Each index moves one 32-byte L2
    sector; the gather also streams 8 bytes an index (the index in, the
    value out), which at the card's memory rate would allow
    ``sector_rate_at_hbm_limit`` before HBM binds.  Prints one line."""
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.rand(PROBE_N, generator=g, device=dev)
    idx = torch.randint(0, PROBE_N, (PROBE_INDICES,), generator=g, device=dev,
                        dtype=torch.int32)
    ms = time_ms(lambda: w.index_select(0, idx), 20)
    sec = ms / 1e3
    probe = {"op": "index_select", "indices": PROBE_INDICES, "n": PROBE_N, "ms": ms,
             "indices_per_s": PROBE_INDICES / sec,
             "sector_bytes_per_s": PROBE_INDICES * L2_SECTOR / sec,
             "stream_bytes": 8 * PROBE_INDICES,
             "stream_bytes_per_s": 8 * PROBE_INDICES / sec,
             "sector_rate_at_hbm_limit": HBM_BYTES_PER_S / 8 * L2_SECTOR}
    print(f"probe gather: {json.dumps(probe)}", flush=True)
    return probe


def hold_step(name: str, got: tuple, want: tuple) -> float:
    """Fail unless a step wrapper's ``(ancestors, state, stats)`` agree with
    its plain version's on the same inputs: the same rows resample, the ESS
    and the largest weight within STATS_RTOL, the evidence increment within
    INCR_ATOL, and then every ancestor and state value equal.  Returns the
    largest |error| of the stats."""
    got = tuple(g.reshape(w.shape) for g, w in zip(got, want))
    gs, ws = got[2], want[2]
    fired_same = torch.equal(gs[:, 2], ws[:, 2])
    rel = ((gs[:, [0, 3]] - ws[:, [0, 3]]).abs() / ws[:, [0, 3]].abs()).max()
    incr_err = (gs[:, 1] - ws[:, 1]).abs().max()
    if not (fired_same and rel <= STATS_RTOL and incr_err <= INCR_ATOL):
        fail(f"{name}: stats differ (fired same {fired_same}, rel {float(rel)}, "
             f"incr {float(incr_err)})\n{gs}\n{ws}")
    # The weights are bit-identical on the card (expf = torch.exp), so with
    # the same trigger the ancestors and the state must agree exactly.
    anc_mismatch = int((got[0] != want[0]).sum())
    if anc_mismatch or not torch.equal(got[1], want[1]):
        fail(f"{name}: {anc_mismatch} ancestors differ with the same trigger, or the state "
             f"(max |err| {float((got[1] - want[1]).abs().max())})")
    return max(float(incr_err), float((gs - ws).abs().max()))


def check_kernel(case, timed: bool = True) -> dict:
    """Hold one wrapper's kernel against its plain version on its captured
    inputs, time both, and compute its bound; fails on any disagreement.
    ``timed=False`` holds it and times nothing (a cut)."""
    name, wrapper, kargs, plain, family, kind, rows, iters = case
    n = kargs[0].shape[-1]
    got = wrapper(*kargs)
    torch.cuda.synchronize()
    # The comparison's own plain call is timed: where one cold call is all
    # the timing makes (the largest cases), it is the plain version's time.
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain()
    end.record()
    torch.cuda.synchronize()
    first_plain_ms = start.elapsed_time(end)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    got = tuple(g.reshape(wnt.shape) for g, wnt in zip(got, want))
    if kind in ("scan", "copy", "lse"):  # a CDF, a copy, a reduction: every bit
        got, want = (got[0].view(torch.int32),), (want[0].view(torch.int32),)
    anc_mismatch = int((got[0] != want[0]).sum())
    state_err = float((got[1] - want[1]).abs().max()) if len(got) > 1 else 0.0
    tpu_file, tpu_line = _tpu_kernel_lines()[TPU_KERNELS.get(wrapper.__name__,
                                                             wrapper.__name__)]
    entry = {"name": name, "route": "cuda",
             "source": f"src/repro_torch/kernels/{SOURCES[family]}",
             "replaces": f"{tpu_file}:{tpu_line}"}
    if wrapper.__name__ in PORT_KERNELS:
        entry["replaces_note"] = (f"no TPU kernel: the call {PORT_KERNELS[wrapper.__name__][1]}"
                                  "...) that the kernel stands for")
    if kind != "step":
        same_state = len(got) == 1 or torch.equal(bits(got[1]), bits(want[1]))
        if anc_mismatch or not same_state:
            fail(f"{name}: kernel and plain version differ ({anc_mismatch} ancestors, "
                 f"state max |err| {state_err}); bit equality is required")
        max_abs_err = state_err
    else:
        max_abs_err = hold_step(name, got, want)
        gs, ws = got[2], want[2]
        entry["rows_resampled"] = int(ws[:, 2].sum())
        # Fixed-order block sums: the stats repeat bit for bit.
        if not torch.equal(wrapper(*kargs)[2].reshape(gs.shape), gs):
            fail(f"{name}: stats differ from one launch to the next")
    if not timed:
        entry.update(max_abs_err=max_abs_err, ancestor_mismatches=anc_mismatch, timed=False)
        print(f"held {name}: {json.dumps(entry)}", flush=True)
        return entry
    # Rejection's work is the rounds this run's data needs (-1: a step row
    # that did not resample runs none).
    rounds = rejection_rounds(kargs, kind, iters) if family == "rejection" else None
    work = rows * n * iters if rounds is None else int((rounds + 1).sum())
    reps = 20 if work < 2e9 else 4
    ms = kernel_ms(lambda: wrapper(*kargs), wrapper.kernel_name(*kargs), reps)
    call_ms = time_ms(lambda: wrapper(*kargs), reps)
    # The plain version warm, in as many calls as fit PLAIN_BUDGET_MS (at
    # most 5); where its comparison call alone took that long, that call.
    plain_reps = max(1, min(5, int(PLAIN_BUDGET_MS // max(first_plain_ms, 1e-3))))
    plain_ms = first_plain_ms if plain_reps == 1 else time_ms(plain, plain_reps, warmup=0)
    library = library_call(kind, kargs) if family in ("prefix", "fixtures", "reduce") else None
    library_ms = None if library is None else time_ms(library, reps)
    if family == "prefix":
        fired = entry.get("rows_resampled", rows)
        n_bytes, n_ops = prefix_work(kind, kargs, rows, n, fired)
    elif family == "fixtures":  # the copy reads and writes N f32, the iota writes N int32
        n_bytes, n_ops = (8 if kind == "copy" else 4) * rows * n, 0
    elif family == "reduce":  # S·N f32 in, S f32 out; a max, a subtract, an exp, an add each
        n_bytes, n_ops = 4 * rows * n + 4 * rows, LSE_OPS * rows * n
    else:
        # Weights (or log-weights) in and ancestors out; the state in and
        # out (D = 1 on the path) for the fused and step kernels, in plane
        # words (4 or 2 bytes); C1/C2's partition table, read once;
        # rejection's sup w pass (plane words) before a rows launch.
        table = kargs[-4 if kind == "step" else -3] if family.startswith("metropolis_c") else None
        word = kargs[0].element_size()
        n_bytes = rows * n * (word + 4 + (0 if kind == "index" else 2 * word))
        if family == "megopolis" and kind != "index":  # the state's own D and word
            n_bytes += 2 * kargs[1].numel() * kargs[1].element_size() - 2 * word * rows * n
        n_bytes += 0 if table is None else 4 * table.numel()
        n_bytes += word * rows * n if family == "rejection" and kind != "step" else 0
        n_ops = work * SWEEP_OPS[family] + rows * n * (PRELUDE_OPS if kind == "step" else 0)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
    entry.update(max_abs_err=max_abs_err,
                 ancestor_mismatches=anc_mismatch, ms=ms, call_ms=call_ms,
                 plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 library_ms=library_ms, rows=rows, n=n, iters=iters, l2="warm")
    if family == "prefix" and kind == "step":
        entry["kind"] = kargs[-1]
    if family == "metropolis":
        # Every random w[j] read moves one L2 sector; one row's weights are
        # the working set the kernel's block order keeps live.
        entry.update(l2_sector_bytes=rows * n * iters * L2_SECTOR,
                     row_weights_fit_l2=word * n <= L2_BYTES,
                     bank_weights_fit_l2=word * n * rows <= L2_BYTES)
    elif family.startswith("metropolis_c"):
        # Every partition tile a block loads is 1024 plane words of weights
        # re-read from L2 (4 KiB, 2 KiB at 2-byte words): once per own tile
        # for C1, once per iteration for C2.
        table = kargs[-4 if kind == "step" else -3]
        loads = rows * (n // 1024) * (1 if family == "metropolis_c1" else iters)
        entry.update(partition_l2_bytes=loads * 1024 * kargs[0].element_size(),
                     table_entries=table.numel())
    elif rounds is not None:
        # One sector a round past round 0 that the chains need; the rate is
        # those bytes over the kernel's time.
        sectors = (work - int((rounds >= 0).sum())) * L2_SECTOR
        entry.update(divergence(rounds, iters), l2_sector_bytes=sectors,
                     l2_sector_tb_s=sectors / (ms * 1e9))
    print(f"kernel {name}: {json.dumps(entry)}", flush=True)
    if rounds is not None and kind == "step":
        # Not measured: the new schedule's rounds, modelled, on a line of
        # their own.
        warps = step_warps(rows, n, kargs[0].dtype)
        print(f"model {name}: {json.dumps(refill_rounds(rounds, warps))}", flush=True)
    return entry


def rejection_rounds(kargs, kind, max_iters) -> torch.Tensor:
    """The round of each lane's accept on a rejection wrapper's inputs
    (``rejection_rounds_ref``), ``[S, N]``: ``max_iters`` at the cap, -1 on
    a step row that did not resample."""
    from repro_torch.kernels.rejection.ref import rejection_rounds_ref

    w = kargs[0].reshape(-1, kargs[0].shape[-1])
    seeds = kargs[1 if kind == "index" else 2].reshape(-1)
    if kind != "step":
        return rejection_rounds_ref(w, seeds, max_iters)
    return rejection_rounds_ref(w, seeds, max_iters, log_weights=True, thr=kargs[-1])


def divergence(rounds: torch.Tensor, max_iters: int) -> dict:
    """Rounds run by the lanes that ran (rounds + 1 each) against the
    rounds of their warps (32 neighbouring lanes, each as many as its
    slowest): the mean of each, the divergence share ``1 - lane / warp``
    (paper §1's SIMD cost) and the share of lanes at the cap."""
    ran = rounds[rounds >= 0]
    if ran.numel() == 0:
        return {"rows_run": 0}
    lane = ran + 1
    warp = (rounds.reshape(-1, WARP) + 1).amax(dim=1)
    warp = warp[warp > 0]
    lane_mean, warp_mean = float(lane.float().mean()), float(warp.float().mean())
    return {"lane_rounds_mean": lane_mean, "warp_rounds_mean": warp_mean,
            "lane_rounds_max": int(lane.max()), "divergence_share": 1 - lane_mean / warp_mean,
            "cap_share": float((ran == max_iters).float().mean())}


def step_warps(rows: int, n: int, dtype) -> int:
    """Warps of the rejection step's cooperative grid for a bank of rows x
    n of plane dtype ``dtype`` (``rejection_step_grid``)."""
    from repro_torch.kernels.common import PLANE_CODES
    from repro_torch.kernels.rejection import rejection as rk

    blocks = ctypes.c_int(0)
    if rk._lib().rejection_step_grid(rows, n, PLANE_CODES[dtype], ctypes.byref(blocks)) != 0:
        fail("rejection_step_grid failed")
    return blocks.value * (256 // WARP)


def rejection_defines(*names: str) -> list:
    """The values of ``#define NAME <int>`` lines of ``rejection.cu``."""
    text = (ROOT / "src/repro_torch/kernels" / SOURCES["rejection"]).read_text()
    return [int(re.search(rf"^#define {name} (\d+)$", text, re.M).group(1)) for name in names]


def refill_rounds(rounds: torch.Tensor, warps: int) -> dict:
    """A model of the rejection step's warp chains (``warp_chains`` in
    ``rejection.cu``, with its ``REJ_CHUNK`` and ``REJ_ROUNDS``) on the
    rounds of ``rejection_rounds_ref`` (-1: a row that does not resample,
    which runs no round), not a measurement: the resampling rows' F
    particles in bank order, in T = F / (W·``REJ_CHUNK``) turns, each split
    among the grid's W ``warps`` into equal pieces, piece p to warp p mod
    W; a warp's 32 lanes each take its next particle when free and run
    ``REJ_ROUNDS`` rounds an iteration (accept round r holds a lane
    ceil((r + 1) / REJ_ROUNDS) iterations), as if every warp ran at one
    speed; when its particles run out and at most 16 lanes are busy, the
    busy ones share the warp, 32 / 2^ceil(log2 busy) lanes each, a round a
    lane.  Returns the warps' mean iterations (of those with work), the
    rounds their lanes issue (32·``REJ_ROUNDS`` an iteration of one
    particle a lane, 32 of a shared one) per particle that ran, and the
    share of those the chains need (the old kernel's is ``1 -
    divergence_share``)."""
    jobs = (rounds[rounds >= 0] + 1).to(torch.int64).cpu()
    if jobs.numel() == 0:
        return {}
    chunk, at_once = rejection_defines("REJ_CHUNK", "REJ_ROUNDS")
    f = jobs.numel()
    pieces = warps * max(1, f // (warps * chunk))
    bounds = torch.arange(pieces + 1, dtype=torch.int64) * f // pieces
    warp = (torch.searchsorted(bounds, torch.arange(f), right=True) - 1) % warps
    order = torch.argsort(warp, stable=True)  # each warp's particles, in bank order
    count = torch.bincount(warp, minlength=warps)
    start = torch.cumsum(count, 0) - count
    queue = torch.zeros(warps, int(count.max()), dtype=torch.int64)
    queue[warp[order], torch.arange(f) - start[warp[order]]] = jobs[order]
    finish = torch.zeros(warps, WARP, dtype=torch.int64)
    last = torch.zeros(warps, dtype=torch.int64)
    rows_ = torch.arange(warps)
    for k in range(queue.shape[1]):
        job = -(-queue[:, k] // at_once)
        t0, lane = finish.min(dim=1)
        has = job > 0
        finish[rows_[has], lane[has]] = t0[has] + job[has]
        last = torch.where(has, t0, last)
    # The rounds left when the warp's particles run out, then a lane a
    # particle while more than 16 are busy, shared lanes after.
    rem = (finish - last.unsqueeze(1)).clamp(min=0) * at_once
    iters, issued = last.clone(), last * WARP * at_once
    while bool((rem > 0).any()):
        nb = (rem > 0).sum(dim=1)
        shared = nb <= 16
        step = torch.where(shared, WARP // 2 ** torch.ceil(torch.log2(
            nb.clamp(min=1).double())).long(), at_once)
        rem = torch.where(rem > 0, (rem - step.unsqueeze(1)).clamp(min=0), rem)
        iters += (nb > 0).long()
        issued += (nb > 0).long() * torch.where(shared, WARP, WARP * at_once)
    busy = iters > 0
    return {"refill_warps": warps,
            "refill_warp_iterations_mean": float(iters[busy].float().mean()),
            "refill_issued_rounds_per_lane": float(issued.sum()) / f,
            "refill_lane_share": float(jobs.sum()) / float(issued.sum())}


def grid_study(case) -> dict:
    """Kernel ms of a cooperative step wrapper on its captured inputs with
    the grid capped at k blocks per SM, for k up to the co-resident count
    the build allows: the step's time against its grid, with its code held
    fixed.  The cap wraps the library's ``<family>_step_grid`` for the
    duration of each timing; launches here do not count."""
    from repro_torch.kernels.common import PLANE_CODES
    from repro_torch.kernels.megopolis import megopolis as mk
    from repro_torch.kernels.metropolis import c1c2 as ck
    from repro_torch.kernels.metropolis import metropolis as tk
    from repro_torch.kernels.rejection import rejection as rk

    name, wrapper, kargs, _, family, kind, rows, _ = case
    if family.startswith("metropolis_c"):
        lib, attr, lead = ck._lib(), "metropolis_c1c2_step_grid", (int(family[-1]),)
    elif family == "prefix":
        from repro_torch.kernels.prefix_sum import prefix_sum as pk
        from repro_torch.kernels.prefix_sum.ref import KIND_CODES

        lib, attr, lead = pk._lib(), "prefix_step_grid", (KIND_CODES[kargs[-1]],)
    else:
        module = {"megopolis": mk, "metropolis": tk, "rejection": rk}[family]
        lib, attr, lead = module._lib(), f"{family}_step_grid", ()
    # Every step grid takes the plane word's code after N.
    word = PLANE_CODES[kargs[0].dtype]
    real = getattr(lib, attr)
    blocks = ctypes.c_int(0)
    with torch.cuda.device(kargs[0].device):
        if real(*lead, rows, kargs[0].shape[-1], word, ctypes.byref(blocks)) != 0:
            fail(f"{name}: {attr} failed")
    sms = torch.cuda.get_device_properties(kargs[0].device).multi_processor_count
    out = {"blocks": blocks.value, "sms": sms, "ms_by_blocks_per_sm": {}}
    top = blocks.value // sms
    for per_sm in sorted({k for k in (2, 4, 6, 8) if k < top} | {top}):
        def capped(*args, cap=per_sm * sms):
            err = real(*args)
            args[-1]._obj.value = min(args[-1]._obj.value, cap)
            return err
        setattr(lib, attr, capped)
        try:
            ms = kernel_ms(lambda: wrapper(*kargs), wrapper.kernel_name(*kargs), 10)
        finally:
            setattr(lib, attr, real)
        out["ms_by_blocks_per_sm"][per_sm] = ms
    return out


def step_costs(family, key, n, b, dev, model, spec, obs) -> dict:
    """What one filter step costs besides the kernel: the key derivation
    (split, split, then the family's tables: offsets and seed for Megopolis,
    the seed alone for Metropolis and rejection, the partition table, drawn
    on the card, and the seed for C1/C2, the draw bases for the prefix-sum
    kinds: N uniforms on the card, or one on the host for improved
    systematic), the UNGM noise draw on the card,
    and a profile
    of a few conditional steps (device time by kernel name and the device's
    busy share of the wall time)."""
    from repro_torch import random as trandom
    from repro_torch.kernels.common import key_to_seed
    from repro_torch.kernels.megopolis.ops import key_tables
    from repro_torch.kernels.metropolis.ops import c1c2_tables
    from repro_torch.kernels.prefix_sum.ops import draw_bases
    from repro_torch.pf.filter import ParticleFilter, run_filter

    base = family.split("@")[0]
    tables = {"megopolis": lambda k: key_tables(k, n, b), "metropolis": key_to_seed,
              "metropolis_c1": lambda k: c1c2_tables(1, k, n, b, dev),
              "metropolis_c2": lambda k: c1c2_tables(2, k, n, b, dev),
              "rejection": key_to_seed}.get(
                  base, lambda k: draw_bases(k[None], n, base, dev))
    reps = 50
    torch.cuda.synchronize()
    t_family = t0 = time.perf_counter()
    k = key
    for _ in range(reps):
        k, ks = trandom.split(k)
        _, k_res = trandom.split(ks)
        tables(k_res)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    normal_ms = time_ms(lambda: trandom.normal(key, (n,), device=dev), 20)
    pf = ParticleFilter(model, n, resampler=spec, ess_threshold=0.5)
    run_filter(key, pf, obs[:3], device=dev)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    steps = 10
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_filter(key, pf, obs[:steps], device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for name, us in device_kernels(prof):
        by_name[name] = by_name.get(name, 0.0) + us
    device_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {
        "key_derivation_ms": host_ms,
        "normal_draw_ms": normal_ms,
        "profiled_steps": steps,
        "wall_ms_per_step": wall / steps * 1e3,
        "device_ms_per_step": device_ms / steps,
        "device_busy_share": device_ms / (wall * 1e3),
        "top_device_ms_per_step": {name[:80]: us / 1e3 / steps for name, us in top},
        "launches_per_step": sum(1 for _ in device_kernels(prof)) / steps,
        "seconds": time.perf_counter() - t_family,
    }


#: The plane dtypes of phase 3's matrix: every cell at each of them.
CHECK_PLANES = ("float32", "bfloat16", "float16")
#: The entry a Path A run goes through, by mode: its launch budget per step.
PATH_A_ENTRIES = {"run_filter/alg6": "apply", "run_filter/conditional": "step",
                  "run_filter_bank/alg6": "apply_rows",
                  "run_filter_bank/conditional": "step_rows", "run_filter_timed/alg6": "apply"}
#: The fixture kernels' length in the contract checks (``AUDIT_N``), and the
#: length they are also timed at: ``oversized_vmem``'s 8M f32.
FIXTURE_NS = (2048, 1 << 23)


def witness_census(witnessed, again):
    """Hold each recorded run's census (the wrappers' launches) against the
    port's kernels among its profiler events, ``witnessed`` as ``(census,
    seen)`` pairs.  The profiler drops a kernel record now and then
    (``kernel_ms``) but never adds one, so a run in which it saw a launch
    that the census lacks fails at once.  If it saw fewer in some runs, the
    recorded runs are driven once more (``again``, which appends to
    ``witnessed``): their censuses must repeat, and each of those runs must
    then be seen exactly."""
    def over(pairs):
        return [(c, s) for c, s in pairs if any(s[k] > c.get(k, 0) for k in s)]

    first = list(witnessed)
    short = [i for i, (c, s) in enumerate(first) if c != s]
    print(f"census witness: {len(first)} recorded runs, {len(short)} differ from the "
          f"profiler")
    if over(first):
        fail(f"the profiler saw launches the census lacks: {over(first)[:5]}")
    if not short:
        return
    print(f"census witness: the profiler saw fewer launches in {[first[i] for i in short][:5]}; "
          f"the recorded runs are driven again")
    del witnessed[:]
    again()
    second = list(witnessed)
    if [c for c, _ in second] != [c for c, _ in first]:
        fail("the recorded runs' censuses changed when they were driven again")
    bad = [(first[i][0], first[i][1], second[i][1]) for i in short
           if second[i][0] != second[i][1]]
    print(f"census witness, again: {len(bad)} of those {len(short)} runs differ from the "
          f"profiler")
    if over(second) or bad:
        fail(f"census and profiler differ: {(over(second) + bad)[:5]}")


def contract_checks(dev, wrappers, fk, lk, drive):
    """Phase 3, the contract checks of ``repro_torch.analysis`` on the card.

    The resource tables (``smem.KERNELS``, ``smem.CARD_LIMITS``) must be the
    card's.  ``--check`` runs with every recorded run profiled: its census
    must equal the count of the port's kernels among the profiler's device
    events (``witness_census``).  The matrix runs once at each dtype of
    ``CHECK_PLANES``, the 2-byte ones in runs of their own whose launches
    count under ``<wrapper>@<dtype>``; each compressed cell must launch what
    its float32 cell does.  ``--selftest`` must pass, the oversized fixture
    with no launch."""
    from repro_torch.analysis import fixtures as afix
    from repro_torch.analysis import smem
    from repro_torch.analysis.report import build_report, summarise

    drift = smem.card_drift()
    if drift:
        fail("the resource tables are not the card's:\n  " + "\n  ".join(drift))
    print(f"smem limits: {json.dumps(smem.card_limits())}")
    for kernel, (regs, static, most, per_sm) in smem.card_attributes().items():
        big = [smem.price(kernel, r, n_) for r, n_ in smem.largest_shapes(kernel)]
        print(f"smem {kernel}: " + json.dumps({
            "registers": regs, "static_smem": static, "max_threads": most,
            "blocks_per_sm": per_sm,
            "largest": [{"rows": fp.rows, "n": fp.n, "smem": fp.smem, "blocks": fp.blocks,
                         "per_sm": fp.per_sm} for fp in big],
            "within": not smem.smem_findings(big)}))

    witnessed = []

    @contextlib.contextmanager
    def witness(rec):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            yield
            torch.cuda.synchronize()
            time.sleep(0.02)
        seen = collections.Counter(k for k in (kernel_instance(name) for name, _ in
                                               device_kernels(prof)) if k in smem.KERNELS)
        witnessed.append((dict(rec.census), dict(seen)))

    # The row reduction runs in the adaptive AIS consumer, which the float32
    # report alone audits.
    port = [w for w in wrappers if w not in fk.WRAPPERS and w not in lk.WRAPPERS]

    def report_at(dtype):
        # The cuda backend's cells, each recorded run profiled: the float32
        # report holds every audit; a 2-byte one, the matrix and pass 7 at
        # that dtype and the transactions repriced at its words.
        more = dtype == "float32"
        return build_report(device=dev, around=witness, plane_dtypes=(dtype,), consumers=more,
                            large_n=more, telemetry=more, backends=("cuda",))

    reports = [drive("analysis/check" + ("" if dt == "float32" else f"@{dt}"),
                     lambda dt=dt: report_at(dt),
                     port + (list(lk.WRAPPERS) if dt == "float32" else []))
               for dt in CHECK_PLANES]
    # The reference backend's cells launch no port kernel; their thousands of
    # small torch launches took 182 s on the card, a third of the run, so
    # they run in the CPU tests, and the card holds the reference backend in
    # the guard phase (``reference_on_card``).
    print("cut analysis/check: the reference backend's 80 cells and pass 7 run in the CPU "
          "tests, not here (182 s on the card)", flush=True)
    for report in reports:
        print(summarise(report))
    matrix = [cell for report in reports for cell in report["matrix"]]
    census = collections.defaultdict(dict)
    for cell in matrix:
        family, backend, entry = cell["cell"].split("/")
        census[f"{family}/{backend}"][entry] = cell["launches"]
    print(f"census by entry: {json.dumps(census)}")
    # The compression axis narrows words and never adds a launch: each
    # compressed cell launches what its float32 cell does.
    launches = {cell["cell"]: cell["launches"] for cell in matrix}
    axis = {c: (k, launches[c.split("@")[0]]) for c, k in launches.items() if "@" in c}
    moved = {c: v for c, v in axis.items() if v[0] != v[1]}
    print(f"census plane axis: {len(axis)} cuda cells at {CHECK_PLANES[1:]}, {len(moved)} "
          f"launch other than their float32 cell")
    cuda_cells = sum(1 for c in launches if "/cuda/" in c and "@" not in c)
    if len(axis) != cuda_cells * (len(CHECK_PLANES) - 1) or moved:
        fail(f"compressed cells missing, or their launches differ from float32's: {moved}")
    witness_census(witnessed, lambda: [report_at(dt) for dt in CHECK_PLANES])
    if not all(report["ok"] for report in reports):
        fail("the contract checks failed on the card (see the VIOLATION lines above)")

    before = fk.copy_launch.launches
    rep = afix.FIXTURES["oversized_vmem"][0](dev)
    if rep.ok or fk.copy_launch.launches != before or rep.launches:
        fail(f"oversized_vmem: expected a refusal with no launch ({rep.violations})")
    print(f"smem oversized_vmem: refused without a launch: {rep.violations[0]}")
    problems = drive("analysis/selftest", lambda: afix.selftest(dev), fk.WRAPPERS)
    if problems:
        fail(f"selftest on the card: {problems}")
    print("selftest: OK")


def path_a_census(args, families, results):
    """Each Path A run of phase 4 launched its entry's budget x steps of the
    port's kernels (the wrappers' counts); printed beside all CUDA launches
    of a conditional step (``step_costs``' profile)."""
    from repro_torch.core.spec import launch_budget

    for mode, entry in PATH_A_ENTRIES.items():
        for family in families:
            steps = results[f"{mode}/{family}"].get("steps", args.steps)
            got = sum(results[f"{mode}/{family}"]["launches"].values())
            want = launch_budget(family.split("@")[0], "cuda", entry) * steps
            if got != want:
                fail(f"{mode}/{family}: {got} port kernel launches, budget x steps {want}")
    split = {family: {"port_per_step": launch_budget(family, "cuda", "step"), "all_cuda_per_step":
                      results["host_and_device_per_step"][family]["launches_per_step"]}
             for family in results["host_and_device_per_step"]}
    print(f"census path_a: every run at budget x steps; conditional step {json.dumps(split)}")


def fixture_cases(dev, fk, afix) -> list:
    """The fixture kernels on their inputs in the contract checks (the
    weights ``leaky_telemetry`` copies, the weights ``hbm_roundtrip``
    takes), then at 2^23, and the copy of a view one element into its
    tensor at 2^23 + 3 and the iota into such a view (their heads and
    tails; not in the ``kernels`` line)."""
    from repro_torch.kernels.fixtures import ref as fref

    (x,) = capture(afix, "copy_launch", lambda: afix.leaky_telemetry(dev))
    (w,) = capture(afix, "iota_launch", lambda: afix.hbm_roundtrip(
        torch.zeros(FIXTURE_NS[0], device=dev), torch.zeros(FIXTURE_NS[0], 4, device=dev)))
    big = torch.rand(FIXTURE_NS[1], generator=torch.Generator().manual_seed(0)).to(dev)
    cases = []
    for suffix, xc, wc in (("", x, w), (f"/n={FIXTURE_NS[1]}", big, big)):
        cases.append((f"copy_launch{suffix}", fk.copy_launch, (xc,),
                      lambda xc=xc: fref.copy_ref(xc), "fixtures", "copy", 1, 1))
        cases.append((f"iota_launch{suffix}", fk.iota_launch, (wc,),
                      lambda wc=wc: fref.iota_ref(wc.shape[0], wc.device), "fixtures", "iota",
                      1, 1))
    view = torch.rand(FIXTURE_NS[1] + 4, generator=torch.Generator().manual_seed(1)).to(dev)[1:]
    cases.append((f"copy_launch/n={view.shape[0]}/offset=1", fk.copy_launch, (view,),
                  lambda: fref.copy_ref(view), "fixtures", "copy", 1, 1))
    out = torch.empty(FIXTURE_NS[1] + 4, dtype=torch.int32, device=dev)[1:].view(1, -1)
    cases.append((f"iota_launch/n={view.shape[0]}/offset=1", fk.iota_launch, (view, out),
                  lambda: fref.iota_ref(view.shape[0], dev), "fixtures", "iota", 1, 1))
    return cases


def _tpu_kernel_lines() -> dict:
    """File and line of each ``def megopolis_pallas*``, ``def
    metropolis_pallas*``, ``def metropolis_c{1,2}_pallas*``, ``def
    rejection_pallas*`` and of the prefix-sum kernels' ``def``s in the JAX
    package's kernel files, of the analyzer's two fixture kernels
    (``_copy_launch``, ``hbm_roundtrip``), and of the first call each of
    ``PORT_KERNELS`` stands for (under the wrapper's name), read as text
    (nothing of the JAX package is imported)."""
    lines = {}
    for rel in ("megopolis/megopolis.py", "metropolis/metropolis.py", "metropolis/c1c2.py",
                "rejection/rejection.py", "prefix_sum/prefix_sum.py", "prefix_sum/search.py",
                "prefix_sum/step.py"):
        rel = f"src/repro/kernels/{rel}"
        for i, line in enumerate((ROOT / rel).read_text().splitlines(), 1):
            if (line.startswith(("def megopolis_pallas", "def metropolis_", "def rejection_",
                                 "def prefix_", "def searchsorted_", "def residual_select"))
                    and "_pallas" in line):
                lines[line[4:line.index("(")]] = (rel, i)
    rel = "src/repro/analysis/fixtures.py"
    for i, line in enumerate((ROOT / rel).read_text().splitlines(), 1):
        if line.startswith(("def _copy_launch(", "def hbm_roundtrip(")):
            lines[line[4:line.index("(")]] = (rel, i)
    for wrapper, (rel, call) in PORT_KERNELS.items():
        lines[wrapper] = (rel, next(i for i, line in enumerate(
            (ROOT / rel).read_text().splitlines(), 1) if call in line))
    return lines


if __name__ == "__main__":
    sys.exit(main())
