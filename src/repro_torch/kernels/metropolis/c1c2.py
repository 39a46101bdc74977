"""Launch wrappers of the Metropolis-C1/C2 CUDA kernels (paper Algs. 3-4),
one per TPU kernel (after ``repro.kernels.metropolis.c1c2``), and their bank
forms on the same kernels:

    metropolis_c1             <- metropolis_c1_pallas        (kernel: rows<1, false, T>, S = 1)
    metropolis_c2             <- metropolis_c2_pallas        (kernel: rows<2, false, T>, S = 1)
    metropolis_c1_batch       <- metropolis_c1_pallas, mapped (kernel: rows<1, false, T>)
    metropolis_c2_batch       <- metropolis_c2_pallas, mapped (kernel: rows<2, false, T>)
    metropolis_c1_fused       <- metropolis_c1_pallas_fused  (kernel: rows<1, true, T>, S = 1)
    metropolis_c2_fused       <- metropolis_c2_pallas_fused  (kernel: rows<2, true, T>, S = 1)
    metropolis_c1_fused_batch <- metropolis_c1_pallas_fused, mapped (kernel: rows<1, true, T>)
    metropolis_c2_fused_batch <- metropolis_c2_pallas_fused, mapped (kernel: rows<2, true, T>)
    metropolis_c1_step        <- metropolis_c1_pallas_step   (kernel: step_rows<1, T>, S = 1)
    metropolis_c2_step        <- metropolis_c2_pallas_step   (kernel: step_rows<2, T>, S = 1)
    metropolis_c1_step_rows   <- metropolis_c1_pallas_step, mapped (kernel: step_rows<1, T>)
    metropolis_c2_step_rows   <- metropolis_c2_pallas_step, mapped (kernel: step_rows<2, T>)

The JAX package has no bank kernel for C1/C2 (its bank forms map the single
kernel over the rows); here a bank is one launch, with one seed and one
partition-table row per row.

Each wrapper takes weights (or log-weights) and state of one plane dtype,
float32, bfloat16 or float16 (``common.PLANE_DTYPES``), and launches the
kernels' instance for that word T; the partition stays one tile of 1024
particles at every dtype, the ancestors are int32 and the stats float32.
Each wrapper checks device, dtype, shape and contiguity, that the
partition table is ``int32[S, T]`` for C1 or ``int32[S, T·B]`` for C2 (T =
N / 1024) with entries in ``[0, T)``, and, for the index-only and fused
kernels, that the weights start on a 16-byte boundary, as C2's bulk copies
of partition tiles need (one rule for both variants); it allocates its
outputs (and the step kernel's scratch) with ``torch.empty``, launches on
``torch.cuda.current_stream()`` and adds one to its ``launches`` count where
it launches.  On CPU tensors it runs the plain version (``ref.py``) and
counts nothing; on a CUDA tensor it launches the kernel or raises.

Seeds (uint32 values in ``int64``) and tables may come from the host: they
are moved to the weights' device, seeds as the int32 bit patterns the
kernels read as ``uint32_t``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.common import (
    PLANE_CODES,
    SEG,
    check_aligned,
    check_launch,
    device_seeds,
    kernel_wrapper,
    plane_instance,
    state_bytes,
    step_buffers,
)
from repro_torch.kernels.metropolis.metropolis import _check
from repro_torch.kernels.metropolis.ref import (
    metropolis_c1c2_rows_ref,
    metropolis_c1c2_step_rows_ref,
)

SOURCE = "metropolis/csrc/c1c2.cu"
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = load(SOURCE)
    if not getattr(lib, "_bound", False):
        lib.metropolis_c1c2_rows.argtypes = [
            _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
        ]
        lib.metropolis_c1c2_rows.restype = _I
        lib.metropolis_c1c2_step_grid.argtypes = [_I, _I, _I, _I, _I, ctypes.POINTER(_I)]
        lib.metropolis_c1c2_step_grid.restype = _I
        lib.metropolis_c1c2_step_rows.argtypes = [
            _I, _P, _P, _P, _P, ctypes.c_float, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
            _P,
        ]
        lib.metropolis_c1c2_step_rows.restype = _I
        lib._bound = True
    return lib


def table_width(variant: int, n: int, num_iters: int) -> int:
    """Entries of one row's partition table: T for C1, T·B for C2."""
    return n // SEG * (1 if variant == 1 else num_iters)


def _check_c1c2(who, variant, w, state, partitions, seeds, num_iters):
    """Validate a bank call; returns ``(S, N, D)``."""
    s, n, d = _check(who, w, state, seeds, num_iters)
    width = table_width(variant, n, num_iters)
    if partitions.dtype != torch.int32 or partitions.shape != (s, width):
        what = "T" if variant == 1 else "T·B"
        raise ValueError(f"{who}: partitions must be int32[S, {what}] = [{s}, {width}]; got "
                         f"{partitions.dtype}{list(partitions.shape)}")
    if not partitions.is_cuda and (partitions.min() < 0 or partitions.max() >= n // SEG):
        raise ValueError(f"{who}: partition tiles must lie in [0, {n // SEG})")
    return s, n, d


def _rows(who, variant, w, state, partitions, seeds, num_iters):
    """One bank call of ``metropolis_c1c2_rows_kernel<variant>``: the kernel
    on a CUDA tensor, the plain version on a CPU tensor."""
    s, n, d = _check_c1c2(who, variant, w, state, partitions, seeds, num_iters)
    if not w.is_cuda:
        return metropolis_c1c2_rows_ref(w, state, partitions, seeds, num_iters, variant)
    check_aligned(who, w)
    parts = partitions.to(w.device).contiguous()
    sd = device_seeds(seeds, w.device)
    anc = torch.empty((s, n), dtype=torch.int32, device=w.device)
    out = None if state is None else torch.empty_like(state)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    check_launch(_lib().metropolis_c1c2_rows(
        variant, w.data_ptr(), None if state is None else state.data_ptr(), parts.data_ptr(),
        sd.data_ptr(), anc.data_ptr(), None if out is None else out.data_ptr(), s, n, d,
        num_iters, state_bytes(state), PLANE_CODES[w.dtype], stream), who)
    return anc if state is None else (anc, out)


def _step(who, variant, lw, state, partitions, seeds, num_iters, thr):
    s, n, d = _check_c1c2(who, variant, lw, state, partitions, seeds, num_iters)
    if not lw.is_cuda:
        return metropolis_c1c2_step_rows_ref(lw, state, partitions, seeds, num_iters, thr,
                                             variant)
    lib = _lib()
    code, sb = PLANE_CODES[lw.dtype], state_bytes(state)
    g, anc, out, stats, scratch = step_buffers(
        lambda rows, n_, ref: lib.metropolis_c1c2_step_grid(variant, rows, n_, sb, code, ref),
        who, lw, state, num_iters)
    parts = partitions.to(lw.device).contiguous()
    sd = device_seeds(seeds, lw.device)
    stream = torch.cuda.current_stream(lw.device).cuda_stream
    check_launch(lib.metropolis_c1c2_step_rows(
        variant, lw.data_ptr(), state.data_ptr(), parts.data_ptr(), sd.data_ptr(), float(thr),
        anc.data_ptr(), out.data_ptr(), stats.data_ptr(), scratch.data_ptr(), s, n, d,
        num_iters, g, sb, code, stream), who)
    return anc, out, stats


def _family(variant: int) -> tuple:
    """The six wrappers of one variant, named after its TPU kernels."""
    c = f"metropolis_c{variant}"

    @kernel_wrapper(plane_instance("metropolis_c1c2_rows_kernel", variant, False, state=0))
    def batch(w, partitions, seeds, num_iters):
        anc = _rows(batch.__name__, variant, w, None, partitions, seeds, num_iters)
        batch.launches += w.is_cuda
        return anc

    @kernel_wrapper(plane_instance("metropolis_c1c2_rows_kernel", variant, False, state=0))
    def single(w, partitions, seed, num_iters):
        anc = _rows(single.__name__, variant, w.unsqueeze(0), None, partitions.unsqueeze(0),
                    seed.reshape(1), num_iters)
        single.launches += w.is_cuda
        return anc[0]

    @kernel_wrapper(plane_instance("metropolis_c1c2_rows_kernel", variant, True, state=1))
    def fused_batch(w, state, partitions, seeds, num_iters):
        result = _rows(fused_batch.__name__, variant, w, state, partitions, seeds, num_iters)
        fused_batch.launches += w.is_cuda
        return result

    @kernel_wrapper(plane_instance("metropolis_c1c2_rows_kernel", variant, True, state=1))
    def fused(w, state, partitions, seed, num_iters):
        anc, out = _rows(fused.__name__, variant, w.unsqueeze(0), state.unsqueeze(0),
                         partitions.unsqueeze(0), seed.reshape(1), num_iters)
        fused.launches += w.is_cuda
        return anc[0], out[0]

    @kernel_wrapper(plane_instance("metropolis_c1c2_step_rows_kernel", variant, state=1))
    def step_rows(lw, state, partitions, seeds, num_iters, thr):
        result = _step(step_rows.__name__, variant, lw, state, partitions, seeds, num_iters,
                       thr)
        step_rows.launches += lw.is_cuda
        return result

    @kernel_wrapper(plane_instance("metropolis_c1c2_step_rows_kernel", variant, state=1))
    def step(lw, state, partitions, seed, num_iters, thr):
        anc, out, stats = _step(step.__name__, variant, lw.unsqueeze(0), state.unsqueeze(0),
                                partitions.unsqueeze(0), seed.reshape(1), num_iters, thr)
        step.launches += lw.is_cuda
        return anc[0], out[0], stats[0]

    single.__doc__ = (
        f"Index-only C{variant} resample of one population ``w [N]`` (a plane dtype) with "
        "its partition table and a scalar ``seed``: ancestors ``int32[N]``.")
    batch.__doc__ = (
        f"Index-only C{variant} resample of a bank ``w [S, N]``, one table row and one "
        "seed per row: ancestors ``int32[S, N]``, row ``s`` the single call on row ``s``.")
    fused.__doc__ = (
        f"Fused C{variant} resample + state copy of one population: ``w [N]``, ``state "
        "[D, N]`` of the same plane dtype; returns ``(ancestors int32[N], state' [D, N])``.")
    fused_batch.__doc__ = (
        f"Fused C{variant} resample + state copy of a bank: ``w [S, N]``, ``state [S, D, "
        "N]``; returns ``(ancestors int32[S, N], state' [S, D, N])``.")
    step.__doc__ = (
        f"Fused SMC step with C{variant} of one population from log-weights ``[N]`` (a "
        "plane dtype; the sweep runs on ``exp(lw - m)`` requantised to it): returns "
        "``(ancestors int32[N], state' [D, N], stats f32[4])``.")
    step_rows.__doc__ = (
        f"Fused SMC step with C{variant} over a bank of log-weights ``[S, N]``, each row "
        "with its own decision: returns ``(ancestors, state', stats f32[S, 4])``.")
    fns = (single, batch, fused, fused_batch, step, step_rows)
    for fn, suffix in zip(fns, ("", "_batch", "_fused", "_fused_batch", "_step", "_step_rows")):
        fn.__name__ = fn.__qualname__ = c + suffix
    return fns


(metropolis_c1, metropolis_c1_batch, metropolis_c1_fused, metropolis_c1_fused_batch,
 metropolis_c1_step, metropolis_c1_step_rows) = _family(1)
(metropolis_c2, metropolis_c2_batch, metropolis_c2_fused, metropolis_c2_fused_batch,
 metropolis_c2_step, metropolis_c2_step_rows) = _family(2)

WRAPPERS = (metropolis_c1, metropolis_c1_batch, metropolis_c1_fused, metropolis_c1_fused_batch,
            metropolis_c1_step, metropolis_c1_step_rows,
            metropolis_c2, metropolis_c2_batch, metropolis_c2_fused, metropolis_c2_fused_batch,
            metropolis_c2_step, metropolis_c2_step_rows)


def reset_launch_counts():
    """Set every wrapper's ``launches`` count to 0."""
    for fn in WRAPPERS:
        fn.launches = 0


reset_launch_counts()
