"""Chip smoke of the PyTorch + CUDA port: drive the resampler paths on one
NVIDIA card and hold every CUDA kernel against its plain version.

    python3 chip_smoke.py            # full width: N = 2**20, B = 32, T = 100, S = 16, K = 64

Phases, in order (any failure exits non-zero; nothing is caught and passed
over, and there is no CPU fallback):

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA source of ``src/repro_torch`` with ``nvcc`` for sm_90a
   (one ``nvcc`` per source, started together) and print ``ptxas``'
   registers per kernel;
3. drive the paths through the user's entry points, each run with every
   kernel's launch count set to 0 just before and read just after:
   * Path A, the particle filter (paper §7, Table 2), once with
     ``MegopolisSpec`` and once with ``MetropolisSpec`` (the baseline
     column): ``run_filter`` in Alg. 6 and in conditional mode (ESS
     threshold 0.5), ``run_filter_bank`` (S scenarios) in both modes, and
     ``run_filter_timed``; RMSE against ``simulate``'s truth, steps/s, the
     resample ratio and a ``StepStats`` summary, the families side by side;
   * Path B, the quality and speed study (paper §6.3, Fig. 6): for each y
     of 0, 2 and 4, Gaussian weights at N particles, B from eq. (3) in
     closed form, K Monte Carlo resamples in one ``batch_rows`` launch,
     then MSE/N and the bias share (eq. 21), and the time of one
     ``r(key, w)`` and one ``r.batch(key, w_bank)``, for both families;
   * small runs of both paths on the card against the same runs on the CPU;
4. for each kernel wrapper, on its inputs captured from a short full-width
   run of the entry point that calls it (for a step, the last captured call
   that resampled), compare the kernel with its plain version on the card,
   time both, and compute the kernel's bound; time each bank step kernel
   at capped cooperative grids (blocks per SM);
5. print the card line, one JSON line of kernels, then a last JSON line
   naming the device.

Run it from the root of a checkout; it needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
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
#: Iterations on Path A, the middle of the paper's B sweep (§7).
ITERS = 32
#: Path B's weight sequences: y of eq. (12), a third of GAUSSIAN_Y_GRID.
PATH_B_YS = (0.0, 2.0, 4.0)
#: Time steps of the short runs whose resampler inputs phase 4 captures.
CAPTURE_STEPS = 5
#: 32-bit operations per (particle, iteration) of each family's sweep,
#: counted from the sources.  Megopolis: index map 6, murmur3 finalizer 8,
#: lane-hash xor 1, shift, convert and scale 3, the product and the compare
#: 2.  Metropolis: two murmur3 finalizers 16, two lane-hash xors 2, the
#: unsigned modulo by N 1 (counted as one operation; it compiles to a dozen
#: or more instructions, so this too is a floor), shift, convert and scale
#: 3, the product and the compare 2.
SWEEP_OPS = {"megopolis": 20, "metropolis": 24}
#: Per particle of the step prelude: max, subtract, exp (about 10), the
#: flushes, three sums, a square and a max.
PRELUDE_OPS = 20
#: Step stats: ess_norm and max_weight are ratios of f32 sums taken in
#: another order than torch.sum; relative error per sum of N = 2**20 terms is
#: well below 1e-5.  incr = m + log(Σw) - log N, absolute.
STATS_RTOL = 1e-5
INCR_ATOL = 1e-5
#: Whole-run agreement of a small filter on the card and on the CPU: the
#: noise differs by a few ULP (log1p, sqrt), which flips a rare accept; each
#: flip moves an estimate by at most the particle range over N.
SMALL_RUN_ATOL = 0.05


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


def device_kernels(prof) -> list:
    """The kernel events of a ``torch.profiler`` run: ``(name, µs)``."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, e.device_time_total) for e in prof.events() if e.device_type == cuda]


def kernel_ms(fn, kernel: str, reps: int = 20) -> float:
    """Mean device time of the CUDA kernel named ``kernel`` over at least
    ``reps`` launches, from the profiler's kernel events (CUDA events around
    the calls would also count the wrapper's host work).  The profiler can
    drop kernel records early in a session (seen on the card: 9 of 25, 19
    of 20), so the profile makes ``3·reps`` calls and averages every launch
    it recorded; each is the same work on the same inputs.  The calls run
    back to back, so the weights are warm in L2, as the filter leaves them."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)
        for _ in range(3 * reps):
            fn()
        torch.cuda.synchronize()
    times = [us for name, us in device_kernels(prof) if kernel in name]
    if len(times) < reps:
        fail(f"profiler saw {len(times)} launches of {kernel} in {3 * reps} calls, "
             f"fewer than {reps}")
    return sum(times) / len(times) / 1e3


def capture(module, name: str, run) -> tuple:
    """The arguments of one call of ``module.<name>`` made by ``run()``: of
    the calls after which some row resampled (every call of an index-only or
    apply wrapper), the last; if there is none, the last call.  These
    launches are not the main path's: its counts are set to 0 before each of
    its runs."""
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
    return (fired or [args for _, args in calls])[-1]


def summary(stats) -> dict:
    return {
        "ess_norm_mean": float(stats.ess_norm.float().mean()),
        "resampled_frac": float(stats.resampled.float().mean()),
        "max_weight_max": float(stats.max_weight.float().max()),
        "survivors_min": int(stats.survivors.min()),
        "degenerate_any": bool(stats.degenerate.any()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--particles", type=int, default=1 << 20)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--bank", type=int, default=16)
    ap.add_argument("--bank-steps", type=int, default=100)
    ap.add_argument("--runs", type=int, default=64, help="Path B's K Monte Carlo resamples")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script measures the card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"{ROOT / 'src' / 'repro_torch'} not found: run from a checkout of the repo")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import random as trandom
    from repro_torch.core.spec import MegopolisSpec, MetropolisSpec
    from repro_torch.kernels import build
    from repro_torch.kernels.megopolis import megopolis as mk
    from repro_torch.kernels.metropolis import metropolis as tk
    from repro_torch.pf.filter import simulate
    from repro_torch.pf.models import ungm, ungm_family

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

    dev = torch.device("cuda")
    n = args.particles
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
    wrappers = mk.WRAPPERS + tk.WRAPPERS
    key = trandom.PRNGKey(args.seed)
    k_sim, k_run, k_bank, k_quality = trandom.split(key, 4)
    model, fam = ungm(), ungm_family()
    truth, obs = simulate(k_sim, model, args.steps, device=dev)
    thetas = {"amp": torch.linspace(6.0, 10.0, args.bank),
              "obs_var": torch.linspace(0.5, 2.0, args.bank)}
    sims = [simulate(k, fam, args.bank_steps, theta={"amp": thetas["amp"][i],
                                                     "obs_var": thetas["obs_var"][i]}, device=dev)
            for i, k in enumerate(trandom.split(k_bank, args.bank))]
    bank_truth = torch.stack([x for x, _ in sims])
    bank_obs = torch.stack([z for _, z in sims])

    # -- 3. the paths ----------------------------------------------------------
    path_launches = {}
    results = {}

    def drive(name, fn, expected, n_steps=None):
        for module in (mk, tk):
            module.reset_launch_counts()
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t_start
        counts = {w.__name__: w.launches for w in wrappers if w.launches}
        for wrapper in expected:
            if counts.get(wrapper.__name__, 0) < 1:
                fail(f"{name}: {wrapper.__name__} was launched no time ({counts})")
        for wname, c in counts.items():
            path_launches[wname] = path_launches.get(wname, 0) + c
        results[name] = {"seconds": secs, "launches": counts}
        if n_steps:
            results[name]["steps_per_s"] = n_steps / secs
        return out

    for family, f in families.items():
        path_a(family, f, args, dev, model, fam, obs, truth, bank_obs, bank_truth, thetas,
               k_run, drive, results)
    for family, f in families.items():
        path_b(family, f, args, dev, k_quality, drive, results)
    results["small_runs_card_vs_cpu"] = small_runs(families, obs, k_run, k_quality, dev)
    results["host_and_device_per_step"] = {
        family: step_costs(family, k_run, n, ITERS, dev, model, f["spec"], obs)
        for family, f in families.items()}
    for name, r in results.items():
        print(f"path {name}: {json.dumps(r, default=float)}", flush=True)
    for mode in ("run_filter/alg6", "run_filter/conditional", "run_filter_bank/alg6",
                 "run_filter_bank/conditional", "run_filter_timed/alg6"):
        side = {family: {k: results[f"{mode}/{family}"].get(k) for k in
                         ("steps_per_s", "rmse", "rmse_mean", "resample_ratio")}
                for family in families}
        print(f"compare {mode}: {json.dumps(side)}")
    for y in PATH_B_YS:
        side = {family: {k: results[f"fig6/y={y}/{family}"][k] for k in
                         ("B", "mse_over_n", "bias_share", "single_ms", "batch_ms")}
                for family in families}
        print(f"compare fig6/y={y}: {json.dumps(side)}")

    # -- 4. kernels against their plain versions --------------------------------
    kernels = []
    for case in kernel_cases(args, dev, families, model, fam, obs, bank_obs, thetas, k_run,
                             k_quality):
        kernels.append(check_kernel(case, path_launches))
        if case[0].endswith("_step_rows"):
            print(f"grid {case[0]}: {json.dumps(grid_study(case))}", flush=True)
    # Launches made above to compare and time do not count: the counts
    # reported are those of the main path's runs.
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


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
    for mode, thr in (("alg6", None), ("conditional", 0.5)):
        pf = ParticleFilter(fam, n, resampler=spec, ess_threshold=thr)
        name = f"run_filter_bank/{mode}/{family}"
        ests, tel = drive(
            name, lambda: run_filter_bank(k_run, pf, bank_obs, thetas, telemetry=True, device=dev),
            [f[f"bank_{mode}"]], args.bank_steps)
        if ests.shape != (s_bank, args.bank_steps) or not torch.isfinite(ests).all():
            fail(f"{name}: estimates not finite of shape ({s_bank}, {args.bank_steps})")
        per_row = [rmse(ests[i].cpu().numpy(), bank_truth[i].cpu().numpy())
                   for i in range(s_bank)]
        results[name].update(rmse_mean=sum(per_row) / s_bank, stats=summary(tel.steps))
    pf = ParticleFilter(model, n, resampler=spec)
    name = f"run_filter_timed/alg6/{family}"
    _, times = drive(name, lambda: run_filter_timed(k_run, pf, obs, device=dev), [f["alg6"]],
                     args.steps)
    results[name].update(resample_ratio=resample_ratio(times), times=times)


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
        r = f["cls"](num_iters=b).build()
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


def small_runs(families, obs, k_run, k_quality, dev) -> dict:
    """Both paths at a small size on the card against the same runs on the
    CPU (plain versions): the filter within ``SMALL_RUN_ATOL``, Path B's
    offspring bit for bit (the same weights on both)."""
    from repro_torch import random as trandom
    from repro_torch.core.metrics import offspring_counts
    from repro_torch.core.weightgen import gaussian_weights
    from repro_torch.pf.filter import ParticleFilter, run_filter
    from repro_torch.pf.models import ungm

    out = {}
    for family, f in families.items():
        small = ParticleFilter(ungm(), 4096, resampler=f["cls"](num_iters=16),
                               ess_threshold=0.5)
        on_card = run_filter(k_run, small, obs[:20], device=dev).cpu()
        on_cpu = run_filter(k_run, small, obs[:20].cpu(), device="cpu")
        err = float((on_card - on_cpu).abs().max())
        if not err <= SMALL_RUN_ATOL:
            fail(f"small {family} filter: card and CPU differ by {err} > {SMALL_RUN_ATOL}")
        r = f["cls"](num_iters=16).build()
        w = gaussian_weights(k_quality, 8192, 2.0, device="cpu")
        keys = trandom.split(k_quality, 4)
        bank = w[None].expand(4, -1).contiguous()
        got = offspring_counts(r.batch_rows(keys, bank.to(dev)), 8192).cpu()
        if not torch.equal(got, offspring_counts(r.batch_rows(keys, bank), 8192)):
            fail(f"small {family} Fig. 6 run: card and CPU offspring differ")
        out[family] = {"filter_max_abs": err, "fig6_offspring_equal": True}
    return out


def kernel_cases(args, dev, families, model, fam, obs, bank_obs, thetas, k_run,
                 k_quality) -> list:
    """Each wrapper's captured inputs, its plain version on them, and what
    its bound needs: ``(name, wrapper, inputs, plain, family, kind, rows,
    iters)``."""
    from repro_torch import random as trandom
    from repro_torch.core.iterations import gaussian_weight_iterations
    from repro_torch.core.weightgen import gaussian_weights
    from repro_torch.kernels.megopolis import megopolis as mk
    from repro_torch.kernels.megopolis import ops as mops
    from repro_torch.kernels.megopolis import ref as mref
    from repro_torch.kernels.metropolis import metropolis as tk
    from repro_torch.kernels.metropolis import ops as tops
    from repro_torch.kernels.metropolis import ref as tref
    from repro_torch.pf.filter import ParticleFilter, run_filter, run_filter_bank

    n = args.particles

    def single(family, thr):
        pf = ParticleFilter(model, n, resampler=families[family]["spec"], ess_threshold=thr)
        return lambda: run_filter(k_run, pf, obs[:CAPTURE_STEPS], device=dev)

    def bank(family, thr):
        pf = ParticleFilter(fam, n, resampler=families[family]["spec"], ess_threshold=thr)
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

    cases = []
    # Megopolis, rows 1-6.
    w, offs, seed = capture(mops, "megopolis", fig6("megopolis", "single"))
    cases.append(("megopolis", mk.megopolis, (w, offs, seed),
                  lambda: mref.megopolis_rows_ref(w[None], offs[None], seed.reshape(1)),
                  "megopolis", "index", 1, offs.shape[-1]))
    wb, offs_b, seeds_b = capture(mops, "megopolis_batch", fig6("megopolis", "batch"))
    cases.append(("megopolis_batch", mk.megopolis_batch, (wb, offs_b, seeds_b),
                  lambda: mref.megopolis_rows_ref(wb, offs_b[None].expand(wb.shape[0], -1),
                                                  seeds_b),
                  "megopolis", "index", wb.shape[0], offs_b.shape[-1]))
    wr, offs_r, seeds_r = capture(mops, "megopolis_rows", fig6("megopolis", "batch_rows"))
    cases.append(("megopolis_rows", mk.megopolis_rows, (wr, offs_r, seeds_r),
                  lambda: mref.megopolis_rows_ref(wr, offs_r, seeds_r),
                  "megopolis", "index", wr.shape[0], offs_r.shape[-1]))
    w1, st1, o1, s1 = capture(mops, "megopolis_fused", single("megopolis", None))
    cases.append(("megopolis_fused", mk.megopolis_fused, (w1, st1, o1, s1),
                  lambda: mref.megopolis_fused_rows_ref(w1[None], st1[None], o1[None],
                                                        s1.reshape(1)),
                  "megopolis", "fused", 1, o1.shape[-1]))
    w2, st2, o2, s2 = capture(mops, "megopolis_fused_rows", bank("megopolis", None))
    cases.append(("megopolis_fused_rows", mk.megopolis_fused_rows, (w2, st2, o2, s2),
                  lambda: mref.megopolis_fused_rows_ref(w2, st2, o2, s2),
                  "megopolis", "fused", w2.shape[0], o2.shape[-1]))
    l3, st3, o3, s3, thr = capture(mops, "megopolis_step", single("megopolis", 0.5))
    cases.append(("megopolis_step", mk.megopolis_step, (l3, st3, o3, s3, thr),
                  lambda: mref.megopolis_step_rows_ref(l3[None], st3[None], o3[None],
                                                       s3.reshape(1), thr),
                  "megopolis", "step", 1, o3.shape[-1]))
    l4, st4, o4, s4, _ = capture(mops, "megopolis_step_rows", bank("megopolis", 0.5))
    cases.append(("megopolis_step_rows", mk.megopolis_step_rows, (l4, st4, o4, s4, thr),
                  lambda: mref.megopolis_step_rows_ref(l4, st4, o4, s4, thr),
                  "megopolis", "step", l4.shape[0], o4.shape[-1]))
    # Metropolis, rows 7-12.
    v, sd, it = capture(tops, "metropolis", fig6("metropolis", "single"))
    cases.append(("metropolis", tk.metropolis, (v, sd, it),
                  lambda: tref.metropolis_rows_ref(v[None], None, sd.reshape(1), it),
                  "metropolis", "index", 1, it))
    vb, sdb, itb = capture(tops, "metropolis_batch", fig6("metropolis", "batch_rows"))
    cases.append(("metropolis_batch", tk.metropolis_batch, (vb, sdb, itb),
                  lambda: tref.metropolis_rows_ref(vb, None, sdb, itb),
                  "metropolis", "index", vb.shape[0], itb))
    v1, t1, sd1, it1 = capture(tops, "metropolis_fused", single("metropolis", None))
    cases.append(("metropolis_fused", tk.metropolis_fused, (v1, t1, sd1, it1),
                  lambda: tref.metropolis_rows_ref(v1[None], t1[None], sd1.reshape(1), it1),
                  "metropolis", "fused", 1, it1))
    v2, t2, sd2, it2 = capture(tops, "metropolis_fused_batch", bank("metropolis", None))
    cases.append(("metropolis_fused_batch", tk.metropolis_fused_batch, (v2, t2, sd2, it2),
                  lambda: tref.metropolis_rows_ref(v2, t2, sd2, it2),
                  "metropolis", "fused", v2.shape[0], it2))
    lv3, t3, sd3, it3, _ = capture(tops, "metropolis_step", single("metropolis", 0.5))
    cases.append(("metropolis_step", tk.metropolis_step, (lv3, t3, sd3, it3, thr),
                  lambda: tref.metropolis_step_rows_ref(lv3[None], t3[None], sd3.reshape(1),
                                                        it3, thr),
                  "metropolis", "step", 1, it3))
    lv4, t4, sd4, it4, _ = capture(tops, "metropolis_step_rows", bank("metropolis", 0.5))
    cases.append(("metropolis_step_rows", tk.metropolis_step_rows, (lv4, t4, sd4, it4, thr),
                  lambda: tref.metropolis_step_rows_ref(lv4, t4, sd4, it4, thr),
                  "metropolis", "step", lv4.shape[0], it4))
    return cases


#: The CUDA kernel each wrapper launches, by family and kind.
KERNEL_NAMES = {
    ("megopolis", "index"): "megopolis_fused_rows_kernel",
    ("megopolis", "fused"): "megopolis_fused_rows_kernel",
    ("megopolis", "step"): "megopolis_step_rows_kernel",
    ("metropolis", "index"): "metropolis_rows_kernel",
    ("metropolis", "fused"): "metropolis_rows_kernel",
    ("metropolis", "step"): "metropolis_step_rows_kernel",
}
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
}


def check_kernel(case, path_launches) -> dict:
    """Hold one wrapper's kernel against its plain version on its captured
    inputs, time both, and compute its bound; fails on any disagreement."""
    name, wrapper, kargs, plain, family, kind, rows, iters = case
    n = kargs[0].shape[-1]
    got = wrapper(*kargs)
    want = plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    got = tuple(g.reshape(wnt.shape) for g, wnt in zip(got, want))
    anc_mismatch = int((got[0] != want[0]).sum())
    state_err = float((got[1] - want[1]).abs().max()) if len(got) > 1 else 0.0
    tpu_file, tpu_line = _tpu_kernel_lines()[TPU_KERNELS[name]]
    entry = {"name": name, "route": "cuda",
             "source": f"src/repro_torch/kernels/{family}/csrc/{family}.cu",
             "replaces": f"{tpu_file}:{tpu_line}"}
    if kind != "step":
        same_state = len(got) == 1 or torch.equal(got[1].view(torch.int32),
                                                  want[1].view(torch.int32))
        if anc_mismatch or not same_state:
            fail(f"{name}: kernel and plain version differ ({anc_mismatch} ancestors, "
                 f"state max |err| {state_err}); bit equality is required")
        max_abs_err = state_err
    else:
        gs, ws = got[2], want[2]
        fired_same = torch.equal(gs[:, 2], ws[:, 2])
        rel = ((gs[:, [0, 3]] - ws[:, [0, 3]]).abs() / ws[:, [0, 3]].abs()).max()
        incr_err = (gs[:, 1] - ws[:, 1]).abs().max()
        if not (fired_same and rel <= STATS_RTOL and incr_err <= INCR_ATOL):
            fail(f"{name}: stats differ (fired same {fired_same}, rel {float(rel)}, "
                 f"incr {float(incr_err)})\n{gs}\n{ws}")
        # The weights are bit-identical on the card (expf = torch.exp), so
        # with the same trigger the ancestors must agree exactly.
        if anc_mismatch or state_err:
            fail(f"{name}: {anc_mismatch} ancestors differ with the same trigger")
        max_abs_err = max(float(incr_err), float((gs - ws).abs().max()))
        entry["rows_resampled"] = int(ws[:, 2].sum())
        # Fixed-order block sums: the stats repeat bit for bit.
        if not torch.equal(wrapper(*kargs)[2].reshape(gs.shape), gs):
            fail(f"{name}: stats differ from one launch to the next")
    work = rows * n * iters
    reps = 20 if work < 2e9 else 4
    ms = kernel_ms(lambda: wrapper(*kargs), KERNEL_NAMES[(family, kind)], reps)
    call_ms = time_ms(lambda: wrapper(*kargs), reps)
    plain_ms = time_ms(plain, max(1, min(5, int(2e9 // work))), warmup=0)
    # Weights (or log-weights) in and ancestors out; the state in and out
    # (D = 1 on the path) for the fused and step kernels.
    n_bytes = rows * n * (8 if kind == "index" else 16)
    n_ops = rows * n * (iters * SWEEP_OPS[family] + (PRELUDE_OPS if kind == "step" else 0))
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
    entry.update(launches=path_launches.get(name, 0), max_abs_err=max_abs_err,
                 ancestor_mismatches=anc_mismatch, ms=ms, call_ms=call_ms,
                 plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 library_ms=None, rows=rows, n=n, iters=iters, l2="warm")
    if family == "metropolis":
        # Every random w[j] read moves one L2 sector; one row's weights are
        # the working set the kernel's block order keeps live.
        entry.update(l2_sector_bytes=rows * n * iters * L2_SECTOR,
                     row_weights_fit_l2=4 * n <= L2_BYTES,
                     bank_weights_fit_l2=4 * n * rows <= L2_BYTES)
    print(f"kernel {name}: {json.dumps(entry)}", flush=True)
    return entry


def grid_study(case) -> dict:
    """Kernel ms of a cooperative step wrapper on its captured inputs with
    the grid capped at k blocks per SM, for k up to the co-resident count
    the build allows: the step's time against its grid, with its code held
    fixed.  The cap wraps the library's ``<family>_step_grid`` for the
    duration of each timing; launches here do not count."""
    from repro_torch.kernels.megopolis import megopolis as mk
    from repro_torch.kernels.metropolis import metropolis as tk

    name, wrapper, kargs, _, family, kind, rows, _ = case
    lib = (mk if family == "megopolis" else tk)._lib()
    attr = f"{family}_step_grid"
    real = getattr(lib, attr)
    blocks = ctypes.c_int(0)
    with torch.cuda.device(kargs[0].device):
        if real(rows, kargs[0].shape[-1], ctypes.byref(blocks)) != 0:
            fail(f"{name}: {attr} failed")
    sms = torch.cuda.get_device_properties(kargs[0].device).multi_processor_count
    out = {"blocks": blocks.value, "sms": sms, "ms_by_blocks_per_sm": {}}
    top = blocks.value // sms
    for per_sm in sorted({k for k in (2, 4, 6, 8) if k < top} | {top}):
        def capped(s, n, ref, cap=per_sm * sms):
            err = real(s, n, ref)
            ref._obj.value = min(ref._obj.value, cap)
            return err
        setattr(lib, attr, capped)
        try:
            ms = kernel_ms(lambda: wrapper(*kargs), KERNEL_NAMES[(family, kind)], 10)
        finally:
            setattr(lib, attr, real)
        out["ms_by_blocks_per_sm"][per_sm] = ms
    return out


def step_costs(family, key, n, b, dev, model, spec, obs) -> dict:
    """What one filter step costs besides the kernel: the host's key
    derivation (split, split, then the family's tables: offsets and seed for
    Megopolis, the seed alone for Metropolis), the UNGM noise draw on the
    card, and a profile of a few conditional steps (device time by kernel
    name and the device's busy share of the wall time)."""
    from repro_torch import random as trandom
    from repro_torch.kernels.common import key_to_seed
    from repro_torch.kernels.megopolis.ops import key_tables
    from repro_torch.pf.filter import ParticleFilter, run_filter

    tables = (lambda k: key_tables(k, n, b)) if family == "megopolis" else key_to_seed
    reps = 200
    t0 = time.perf_counter()
    k = key
    for _ in range(reps):
        k, ks = trandom.split(k)
        _, k_res = trandom.split(ks)
        tables(k_res)
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
        "host_key_derivation_ms": host_ms,
        "normal_draw_ms": normal_ms,
        "profiled_steps": steps,
        "wall_ms_per_step": wall / steps * 1e3,
        "device_ms_per_step": device_ms / steps,
        "device_busy_share": device_ms / (wall * 1e3),
        "top_device_ms_per_step": {name[:80]: us / 1e3 / steps for name, us in top},
        "launches_per_step": sum(1 for _ in device_kernels(prof)) / steps,
    }


def _tpu_kernel_lines() -> dict:
    """File and line of each ``def megopolis_pallas*`` and ``def
    metropolis_pallas*`` in the JAX package's kernel files, read as text
    (nothing of the JAX package is imported)."""
    lines = {}
    for family in ("megopolis", "metropolis"):
        rel = f"src/repro/kernels/{family}/{family}.py"
        for i, line in enumerate((ROOT / rel).read_text().splitlines(), 1):
            if line.startswith(f"def {family}_pallas"):
                lines[line[4:line.index("(")]] = (rel, i)
    return lines


if __name__ == "__main__":
    sys.exit(main())
