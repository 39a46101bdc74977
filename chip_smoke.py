"""Chip smoke of the PyTorch + CUDA port: drive the Megopolis particle-filter
path on one NVIDIA card and hold its CUDA kernels against their plain
versions.

    python3 chip_smoke.py            # full width: N = 2**20, B = 32, T = 100, S = 16

Phases, in order (any failure exits non-zero; nothing is caught and passed
over, and there is no CPU fallback):

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA source of ``src/repro_torch`` with ``nvcc`` for sm_90a;
3. drive the main path through the user's entry points, each with the
   kernels' launch counts set to 0 just before and read just after:
   ``run_filter`` in Alg. 6 and in conditional mode (ESS threshold 0.5),
   ``run_filter_bank`` (S scenarios) in both modes, and ``run_filter_timed``;
   print RMSE against ``simulate``'s truth, steps/s, the resample ratio and a
   ``StepStats`` summary; check that every estimate is finite and that a
   small filter run on the card agrees with the same run on the CPU;
4. for each kernel wrapper, on its inputs captured from one step of a short
   full-width run of the entry point that calls it (the last captured step
   that resampled), compare the kernel with its plain version on the card
   and time both;
5. print one JSON line of kernels, then a last JSON line naming the device.

Run it from the root of a checkout; it needs one card.
"""

from __future__ import annotations

import argparse
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
#: per clock); the sweep is mostly 32-bit integer work (IMAD, shifts, XOR,
#: LOP3), which issues at 64 lanes per SM per clock, a quarter to a half of
#: that count.  So the operations bound below is 2-4x below what the integer
#: work can reach: a floor, not an estimate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: Megopolis iterations on the path, the middle of the paper's B sweep (§7).
ITERS = 32
#: Time steps of the short runs whose resampler inputs phase 4 captures.
CAPTURE_STEPS = 5
#: 32-bit operations per (particle, iteration) of the Megopolis sweep: index
#: map 6, murmur3 finalizer 8, lane-hash xor 1, shift, convert and scale 3,
#: the product and the compare 2.
SWEEP_OPS = 20
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
    """Mean device time of the CUDA kernel named ``kernel`` over ``reps``
    calls of its wrapper, from the profiler's kernel events (CUDA events
    around the calls would also count the wrapper's host work)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [us for name, us in device_kernels(prof) if kernel in name]
    if len(times) != reps:
        fail(f"profiler saw {len(times)} launches of {kernel}, expected {reps}")
    return sum(times) / reps / 1e3


def capture(module, name: str, run) -> tuple:
    """The arguments of one call of ``module.<name>`` made by ``run()``: of
    the calls after which some row resampled (every call of an apply
    wrapper), the last; if there is none, the last call.  These launches are
    not the main path's: its counts are set to 0 before each of its runs."""
    real = getattr(module, name)
    calls = []

    def record(*args):
        out = real(*args)
        fired = len(out) == 2 or bool(out[2].reshape(-1, 4)[:, 2].any())
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
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script measures the card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"{ROOT / 'src' / 'repro_torch'} not found: run from a checkout of the repo")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import random as trandom
    from repro_torch.core.spec import MegopolisSpec
    from repro_torch.kernels import build
    from repro_torch.kernels.megopolis import megopolis as mk
    from repro_torch.kernels.megopolis import ref
    from repro_torch.kernels.megopolis import ops
    from repro_torch.pf.filter import (
        ParticleFilter, run_filter, run_filter_bank, run_filter_timed, simulate,
    )
    from repro_torch.pf.metrics import resample_ratio, rmse
    from repro_torch.pf.models import ungm, ungm_family

    card = card_line()
    print(f"card: {card}", flush=True)

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {len(logs)} source(s) in {time.perf_counter() - t0:.1f} s")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    dev = torch.device("cuda")
    n, b, steps, s_bank = args.particles, ITERS, args.steps, args.bank
    spec = MegopolisSpec(num_iters=b)
    key = trandom.PRNGKey(args.seed)
    k_sim, k_run, k_bank = trandom.split(key, 3)
    model = ungm()
    truth, obs = simulate(k_sim, model, steps, device=dev)

    # -- 3. the main path ------------------------------------------------------
    path_launches = {}
    results = {}

    def drive(name, fn, wrapper, n_steps):
        mk.reset_launch_counts()
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t_start
        counts = {w.__name__: w.launches for w in mk.WRAPPERS}
        if counts[wrapper.__name__] < 1:
            fail(f"{name}: {wrapper.__name__} was launched no time ({counts})")
        path_launches[wrapper.__name__] = path_launches.get(wrapper.__name__, 0) + counts[
            wrapper.__name__]
        results[name] = {"seconds": secs, "steps_per_s": n_steps / secs, "launches": counts}
        return out

    # Warm up (CUDA context, allocator, kernel load) before anything is timed.
    for thr in (None, 0.5):
        run_filter(k_run, ParticleFilter(model, n, resampler=spec, ess_threshold=thr),
                   obs[:3], device=dev)
    for mode, thr in (("alg6", None), ("conditional", 0.5)):
        pf = ParticleFilter(model, n, resampler=spec, ess_threshold=thr)
        wrapper = mk.megopolis_fused if thr is None else mk.megopolis_step
        ests, tel = drive(f"run_filter/{mode}",
                          lambda: run_filter(k_run, pf, obs, telemetry=True, device=dev),
                          wrapper, steps)
        if ests.shape != (steps,) or not torch.isfinite(ests).all():
            fail(f"run_filter/{mode}: estimates not finite of shape ({steps},)")
        results[f"run_filter/{mode}"].update(
            rmse=rmse(ests.cpu().numpy(), truth.cpu().numpy()), stats=summary(tel.steps))

    fam = ungm_family()
    thetas = {"amp": torch.linspace(6.0, 10.0, s_bank), "obs_var": torch.linspace(0.5, 2.0, s_bank)}
    sims = [simulate(k, fam, args.bank_steps, theta={"amp": thetas["amp"][i],
                                                     "obs_var": thetas["obs_var"][i]}, device=dev)
            for i, k in enumerate(trandom.split(k_bank, s_bank))]
    bank_truth = torch.stack([x for x, _ in sims])
    bank_obs = torch.stack([z for _, z in sims])
    for thr in (None, 0.5):
        run_filter_bank(k_run, ParticleFilter(fam, n, resampler=spec, ess_threshold=thr),
                        bank_obs[:, :2], thetas, device=dev)
    for mode, thr in (("alg6", None), ("conditional", 0.5)):
        pf = ParticleFilter(fam, n, resampler=spec, ess_threshold=thr)
        wrapper = mk.megopolis_fused_rows if thr is None else mk.megopolis_step_rows
        ests, tel = drive(
            f"run_filter_bank/{mode}",
            lambda: run_filter_bank(k_run, pf, bank_obs, thetas, telemetry=True, device=dev),
            wrapper, args.bank_steps)
        if ests.shape != (s_bank, args.bank_steps) or not torch.isfinite(ests).all():
            fail(f"run_filter_bank/{mode}: estimates not finite of shape "
                 f"({s_bank}, {args.bank_steps})")
        per_row = [rmse(ests[i].cpu().numpy(), bank_truth[i].cpu().numpy())
                   for i in range(s_bank)]
        results[f"run_filter_bank/{mode}"].update(
            rmse_mean=sum(per_row) / s_bank, stats=summary(tel.steps))

    pf = ParticleFilter(model, n, resampler=spec)
    _, times = drive("run_filter_timed/alg6",
                     lambda: run_filter_timed(k_run, pf, obs, device=dev),
                     mk.megopolis_fused, steps)
    results["run_filter_timed/alg6"].update(resample_ratio=resample_ratio(times), times=times)

    # A small run on the card against the same run on the CPU (plain versions).
    small = ParticleFilter(model, 4096, resampler=MegopolisSpec(num_iters=16), ess_threshold=0.5)
    on_card = run_filter(k_run, small, obs[:20], device=dev).cpu()
    on_cpu = run_filter(k_run, small, obs[:20].cpu(), device="cpu")
    small_err = float((on_card - on_cpu).abs().max())
    if not small_err <= SMALL_RUN_ATOL:
        fail(f"small run: card and CPU estimates differ by {small_err} > {SMALL_RUN_ATOL}")
    results["small_run_card_vs_cpu_max_abs"] = small_err
    results["host_and_device_per_step"] = step_costs(k_run, n, b, dev, model, spec, obs)
    for name, r in results.items():
        print(f"path {name}: {json.dumps(r, default=float)}", flush=True)

    # -- 4. kernels against their plain versions --------------------------------
    # Inputs of the full-width path: each wrapper's arguments in one step of a
    # short run of the entry point that calls it.
    def single(thr):
        pf = ParticleFilter(model, n, resampler=spec, ess_threshold=thr)
        return lambda: run_filter(k_run, pf, obs[:CAPTURE_STEPS], device=dev)

    def bank(thr):
        pf = ParticleFilter(fam, n, resampler=spec, ess_threshold=thr)
        return lambda: run_filter_bank(k_run, pf, bank_obs[:, :CAPTURE_STEPS], thetas,
                                       device=dev)

    w, state, offs, seed = capture(ops, "megopolis_fused", single(None))
    wb, state_b, offs_b, seeds_b = capture(ops, "megopolis_fused_rows", bank(None))
    lw, state_s, offs_s, seed_s, thr = capture(ops, "megopolis_step", single(0.5))
    lwb, state_sb, offs_sb, seeds_sb, _ = capture(ops, "megopolis_step_rows", bank(0.5))
    cases = [
        ("megopolis_fused", mk.megopolis_fused, (w, state, offs, seed),
         lambda: ref.megopolis_fused_rows_ref(w[None], state[None], offs[None], seed[None]),
         "megopolis_pallas_fused", 1),
        ("megopolis_fused_rows", mk.megopolis_fused_rows, (wb, state_b, offs_b, seeds_b),
         lambda: ref.megopolis_fused_rows_ref(wb, state_b, offs_b, seeds_b),
         "megopolis_pallas_fused_rows", s_bank),
        ("megopolis_step", mk.megopolis_step, (lw, state_s, offs_s, seed_s, thr),
         lambda: ref.megopolis_step_rows_ref(lw[None], state_s[None], offs_s[None],
                                             seed_s[None], thr),
         "megopolis_pallas_step", 1),
        ("megopolis_step_rows", mk.megopolis_step_rows, (lwb, state_sb, offs_sb, seeds_sb, thr),
         lambda: ref.megopolis_step_rows_ref(lwb, state_sb, offs_sb, seeds_sb, thr),
         "megopolis_pallas_step_rows", s_bank),
    ]
    tpu_lines = _tpu_kernel_lines()
    kernels = []
    for name, wrapper, kargs, plain, tpu_name, rows in cases:
        got = wrapper(*kargs)
        want = plain()
        torch.cuda.synchronize()
        got = tuple(g.reshape(wnt.shape) for g, wnt in zip(got, want))
        anc_mismatch = int((got[0] != want[0]).sum())
        state_err = float((got[1] - want[1]).abs().max())
        entry = {"name": name, "route": "cuda",
                 "source": "src/repro_torch/kernels/megopolis/csrc/megopolis.cu",
                 "replaces": f"src/repro/kernels/megopolis/megopolis.py:{tpu_lines[tpu_name]}"}
        if len(got) == 2:
            if anc_mismatch or not torch.equal(got[1].view(torch.int32),
                                               want[1].view(torch.int32)):
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
        kernel = "megopolis_step_rows_kernel" if "step" in name else "megopolis_fused_rows_kernel"
        ms = kernel_ms(lambda: wrapper(*kargs), kernel)
        call_ms = time_ms(lambda: wrapper(*kargs), 20)
        plain_ms = time_ms(plain, 5, warmup=1)
        n_bytes = rows * n * (4 + 4 + 4 + 4)  # weights, state in, ancestors, state out
        n_ops = rows * n * (b * SWEEP_OPS + (PRELUDE_OPS if "step" in name else 0))
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
        entry.update(launches=path_launches.get(name, 0), max_abs_err=max_abs_err,
                     ancestor_mismatches=anc_mismatch, ms=ms, call_ms=call_ms,
                     plain_ms=plain_ms,
                     bound_ms=max(t_bytes, t_ops),
                     bound_by="bytes" if t_bytes >= t_ops else "operations",
                     library_ms=None)
        kernels.append(entry)
    # Launches made above to compare and time do not count: the counts
    # reported are those of the main path's runs.
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def step_costs(key, n, b, dev, model, spec, obs) -> dict:
    """What one filter step costs besides the kernel: the host's key
    derivation (split, split, offsets and seed), the UNGM noise draw on the
    card, and a profile of a few conditional steps (device time by kernel
    name and the device's busy share of the wall time)."""
    from repro_torch import random as trandom
    from repro_torch.kernels.megopolis.ops import key_tables
    from repro_torch.pf.filter import ParticleFilter, run_filter

    reps = 200
    t0 = time.perf_counter()
    k = key
    for _ in range(reps):
        k, ks = trandom.split(k)
        _, k_res = trandom.split(ks)
        key_tables(k_res, n, b)
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
    """Line of each ``def megopolis_pallas_*`` in the JAX package's kernel
    file, read as text (nothing of the JAX package is imported)."""
    path = ROOT / "src" / "repro" / "kernels" / "megopolis" / "megopolis.py"
    lines = {}
    for i, line in enumerate(path.read_text().splitlines(), 1):
        if line.startswith("def megopolis_pallas"):
            lines[line[4:line.index("(")]] = i
    return lines


if __name__ == "__main__":
    sys.exit(main())
