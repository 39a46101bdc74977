"""Pass 7 — guard neutrality (DESIGN.md §16), after ``repro.analysis.guards``.

The §16 contract is that degeneracy guards are FREE until they fire:

  * **flag identity**: ``guard='flag'`` runs the same program as
    ``guard='off'``.  JAX compares the two traced jaxprs; the port records
    the sequence of torch functions each step calls outside the kernel
    wrappers (a ``TorchFunctionMode``, as ``walker.Taint`` watches a run)
    and the port-kernel census, and requires both equal.  No recorder of
    resilience events is active here, so ``'flag'`` must add nothing.
  * **recover parity**: ``guard='recover'`` may add the ``torch.where``
    substitution but keeps the port-kernel census of ``'off'`` (the
    recovery is before the launch, never a second launch) and returns
    bit-identical outputs on CLEAN inputs.
  * **recovery**: on a fully collapsed bank (all NaN) ``'recover'`` returns
    finite state, in-range ancestors, ``degenerate = True``, a finite
    ``log_evidence_incr`` and ``resampled = 1``: with ``GUARD_THRESHOLD`` 2
    the recovered uniform bank (ESS/N exactly 1) resamples.

Every cell runs on the device the checks are given: the kernels on
``cuda`` tensors, their plain versions or the reference on the CPU.
"""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

from repro_torch import random as trandom
from repro_torch import resolve_device
from repro_torch.analysis import contracts
from repro_torch.core.spec import BACKENDS, list_resamplers, spec_for_backend
from repro_torch.kernels.common import inside_kernel_wrapper

#: Probe geometry, the JAX pass's: two tiles of particles.
GUARD_N = 2048
GUARD_NUM_ITERS = 16
GUARD_MAX_ITERS = 64
#: ESS/N of the recovered uniform bank is exactly 1.0, so this threshold
#: forces the resample branch: the recovery must RESAMPLE.
GUARD_THRESHOLD = 2.0


class CallLog(TorchFunctionMode):
    """The torch functions a run calls outside the kernel wrappers, in
    order, by name."""

    def __init__(self):
        super().__init__()
        self.calls: list = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if not inside_kernel_wrapper():
            self.calls.append(getattr(func, "__qualname__", getattr(func, "__name__",
                                                                    repr(func))))
        return func(*args, **(kwargs or {}))


def _build(name: str, backend: str, guard: str, plane_dtype: str):
    return spec_for_backend(name, backend, num_iters=GUARD_NUM_ITERS,
                            max_iters=GUARD_MAX_ITERS, plane_dtype=plane_dtype,
                            guard=guard).build()


def probe_inputs(device):
    """The probe's key (on the CPU, as the filter keeps it), clean
    log-weights and particles on ``device``."""
    key = trandom.PRNGKey(7)
    kw, kp = trandom.split(key)
    dev = resolve_device(device)
    return key, trandom.normal(kw, (GUARD_N,), device=dev), \
        trandom.normal(kp, (GUARD_N,), device=dev)


def _bits(x: torch.Tensor) -> torch.Tensor:
    x = x.detach().cpu().contiguous()
    if x.dtype.is_floating_point:
        return x.float().view(torch.int32)
    return x.to(torch.int64)


def _tensors(out):
    p_out, ancestors, stats = out
    return [p_out, ancestors, *stats]


def _step(r, key, lw, particles):
    return lambda: r.step(key, lw, particles, GUARD_THRESHOLD)


def _calls(program) -> list:
    with CallLog() as log:
        program()
    return log.calls


def compare_guard_runs(cell: str, r_off, r_flag, r_recover, device="cuda",
                       around=None) -> dict:
    """Grade one (family, backend[, plane_dtype]) cell, or any three objects
    with a ``step``, for §16 guard neutrality."""
    key, lw, particles = probe_inputs(device)
    violations = []

    calls_off = _calls(_step(r_off, key, lw, particles))
    calls_flag = _calls(_step(r_flag, key, lw, particles))
    out_off, rec_off = contracts.record(_step(r_off, key, lw, particles), taint=False,
                                        around=around)
    _, rec_flag = contracts.record(_step(r_flag, key, lw, particles), taint=False,
                                   around=around)
    out_rec, rec_rec = contracts.record(_step(r_recover, key, lw, particles), taint=False,
                                        around=around)
    flag_match = calls_flag == calls_off and rec_flag.census == rec_off.census
    if not flag_match:
        violations.append(
            "guard='flag' changed the step program: it must call the torch functions "
            "and launch the kernels of guard='off', the degenerate flag being composed "
            "under every policy and the event emitted only to an active recorder "
            "(DESIGN.md §16)")
    launches_off, launches_rec = dict(rec_off.census), dict(rec_rec.census)
    if launches_rec != launches_off:
        violations.append(
            f"guard='recover' changed the kernel census: {launches_off} off vs "
            f"{launches_rec} recover (the uniform-bank substitution is before the "
            "launch, never a second launch, DESIGN.md §16)")
    clean_ok = all(a.shape == b.shape and torch.equal(_bits(a), _bits(b))
                   for a, b in zip(_tensors(out_off), _tensors(out_rec)))
    if not clean_ok:
        violations.append(
            "guard='recover' perturbed a CLEAN step: outputs must be bit-identical to "
            "guard='off' when no row is degenerate (torch.where on a False mask is an "
            "exact pass-through, DESIGN.md §16)")
    bad = torch.full_like(lw, float("nan"))
    p_out, ancestors, stats = r_recover.step(key, bad, particles, GUARD_THRESHOLD)
    anc = ancestors.cpu()
    degenerate_ok = (
        bool(torch.isfinite(p_out).all())
        and bool(((anc >= 0) & (anc < GUARD_N)).all())
        and bool(stats.degenerate)
        and bool(torch.isfinite(stats.log_evidence_incr).all())
        and float(stats.resampled) == 1.0
    )
    if not degenerate_ok:
        violations.append(
            "guard='recover' failed to recover an all-NaN bank: the step must resample "
            "from the uniform fallback with finite outputs, in-range ancestors and "
            "degenerate=True (DESIGN.md §16)")
    return {
        "cell": cell,
        "ok": not violations,
        "flag_program_match": flag_match,
        "launches_off": sum(launches_off.values()),
        "launches_recover": sum(launches_rec.values()),
        "clean_bit_identical": clean_ok,
        "degenerate_recovered": degenerate_ok,
        "violations": violations,
    }


def audit_guard_cell(name: str, backend: str, plane_dtype: str = "float32", device="cuda",
                     around=None) -> dict:
    """Audit one (family, backend, plane_dtype) step cell for guard
    neutrality."""
    suffix = "" if plane_dtype == "float32" else f"@{plane_dtype}"
    r_off, r_flag, r_rec = (_build(name, backend, guard, plane_dtype)
                            for guard in ("off", "flag", "recover"))
    return compare_guard_runs(f"{name}/{backend}/step{suffix}", r_off, r_flag, r_rec,
                              device, around)


def audit_guards(families=None, backends=None, plane_dtypes=("float32",), device="cuda",
                 around=None):
    """Audit guard neutrality across the registry matrix; returns a generator
    of cell dicts (``cuda`` without a card raises here, before the first)."""
    device = resolve_device(device)
    return (audit_guard_cell(name, backend, dtype, device, around)
            for dtype in plane_dtypes
            for name in (families if families is not None else list_resamplers())
            for backend in (backends if backends is not None else BACKENDS))
