"""Launch wrappers of the rejection CUDA kernels, one per TPU kernel (after
``repro.kernels.rejection.rejection``):

    rejection              <- rejection_pallas              (kernel: rows<false, T>, S = 1)
    rejection_batch        <- rejection_pallas_batch        (kernel: rows<false, T>)
    rejection_fused        <- rejection_pallas_fused        (kernel: rows<true, T>, S = 1)
    rejection_fused_batch  <- rejection_pallas_fused_batch  (kernel: rows<true, T>)
    rejection_step         <- rejection_pallas_step         (kernel: step_rows<T>, S = 1)
    rejection_step_rows    <- rejection_pallas_step_rows    (kernel: step_rows<T>)

Each wrapper takes weights (or log-weights) and state of one plane dtype,
float32, bfloat16 or float16 (``common.PLANE_DTYPES``), and launches the
kernels' instance for that word T; the ancestors are int32 and the stats
float32 at every dtype.  It checks device, dtype, shape and contiguity,
allocates its
outputs (and the step kernel's scratch) with ``torch.empty``, launches on
``torch.cuda.current_stream()`` and adds one to its ``launches`` count where
it launches.  On CPU tensors it runs the plain version (``ref.py``) and
counts nothing; on a CUDA tensor it launches the kernel or raises.

The non-step wrappers reduce ``sup w`` per row on the weights' device
before the launch, as the JAX wrappers do outside their kernels:
``flush_to_zero(amax(w))`` upcast to float32 (at a 2-byte dtype the max of
the plane words, as JAX's ``jnp.max(w).astype(f32)``), which equals the
plain version's max of the flushed row (flushing is monotone, and a NaN
propagates through both).
The step kernel latches its own (see ``csrc/rejection.cu``).

Seeds (uint32 values in ``int64``) may come from the host: they are moved to
the weights' device as the int32 bit patterns the kernels read as
``uint32_t``.  The port's limits are those of its index arithmetic: N <=
2**30, N % 1024 == 0, S·N < 2**31.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.common import (
    PLANE_CODES,
    PLANE_DTYPES,
    check_bank,
    check_launch,
    device_seeds,
    flush_to_zero,
    kernel_wrapper,
    plane_instance,
    state_bytes,
    step_buffers,
)
from repro_torch.kernels.rejection.ref import rejection_rows_ref, rejection_step_rows_ref

SOURCE = "rejection/csrc/rejection.cu"
#: Largest ``max_iters`` of every wrapper, as the JAX loop takes: rounds 0 ..
#: max_iters count in an int (the kernels count the rounds left down).
MAX_ITERS = (1 << 31) - 2
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = load(SOURCE)
    if not getattr(lib, "_bound", False):
        lib.rejection_rows.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        lib.rejection_rows.restype = _I
        lib.rejection_step_grid.argtypes = [_I, _I, _I, _I, ctypes.POINTER(_I)]
        lib.rejection_step_grid.restype = _I
        lib.rejection_step_rows.argtypes = [
            _P, _P, _P, ctypes.c_float, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
        ]
        lib.rejection_step_rows.restype = _I
        lib._bound = True
    return lib


def _check(who: str, w, state, seeds, max_iters):
    """Validate a bank call with ``max_iters`` at most ``MAX_ITERS``;
    returns ``(S, N, D)``."""
    if (isinstance(max_iters, bool) or not isinstance(max_iters, int)
            or not 1 <= max_iters <= MAX_ITERS):
        raise ValueError(
            f"{who}: max_iters must be an int in [1, {MAX_ITERS}]; got {max_iters!r}")
    return check_bank(who, w, state, seeds, PLANE_DTYPES)


def _launch_rows(w, state, seeds, max_iters, who):
    s, n, d = _check(who, w, state, seeds, max_iters)
    sd = device_seeds(seeds, w.device)
    w_max = flush_to_zero(torch.amax(w, dim=-1).to(torch.float32))
    anc = torch.empty((s, n), dtype=torch.int32, device=w.device)
    out = None if state is None else torch.empty_like(state)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    check_launch(_lib().rejection_rows(
        w.data_ptr(), w_max.data_ptr(), sd.data_ptr(),
        None if state is None else state.data_ptr(), anc.data_ptr(),
        None if out is None else out.data_ptr(), s, n, d, max_iters, state_bytes(state),
        PLANE_CODES[w.dtype], stream), who)
    return anc if state is None else (anc, out)


def _launch_step(lw, state, seeds, max_iters, thr, who):
    s, n, d = _check(who, lw, state, seeds, max_iters)
    lib = _lib()
    code, sb = PLANE_CODES[lw.dtype], state_bytes(state)
    # No hash prefixes: the kernel hashes each round in the thread.
    g, anc, out, stats, scratch = step_buffers(
        lambda rows, n_, blocks: lib.rejection_step_grid(rows, n_, sb, code, blocks), who, lw,
        state, 0)
    sd = device_seeds(seeds, lw.device)
    stream = torch.cuda.current_stream(lw.device).cuda_stream
    check_launch(lib.rejection_step_rows(
        lw.data_ptr(), state.data_ptr(), sd.data_ptr(), float(thr), anc.data_ptr(),
        out.data_ptr(), stats.data_ptr(), scratch.data_ptr(), s, n, d, max_iters, g, sb, code,
        stream), who)
    return anc, out, stats


def _rows(who, w, state, seeds, max_iters):
    """One bank call of ``rejection_rows_kernel``: the kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if not w.is_cuda:
        _check(who, w, state, seeds, max_iters)
        return rejection_rows_ref(w, state, seeds, max_iters)
    return _launch_rows(w, state, seeds, max_iters, who)


def _step(who, lw, state, seeds, max_iters, thr):
    if not lw.is_cuda:
        _check(who, lw, state, seeds, max_iters)
        return rejection_step_rows_ref(lw, state, seeds, max_iters, thr)
    return _launch_step(lw, state, seeds, max_iters, thr, who)


@kernel_wrapper(plane_instance("rejection_rows_kernel", False, state=0))
def rejection_batch(w: torch.Tensor, seeds: torch.Tensor, max_iters: int):
    """Index-only resample of a bank ``w [S, N]`` (a plane dtype) with one seed per row
    ``[S]``.  Returns ``ancestors int32[S, N]``; row ``s`` equals
    ``rejection(w[s], seeds[s], max_iters)``."""
    anc = _rows("rejection_batch", w, None, seeds, max_iters)
    rejection_batch.launches += w.is_cuda
    return anc


@kernel_wrapper(plane_instance("rejection_rows_kernel", False, state=0))
def rejection(w: torch.Tensor, seed: torch.Tensor, max_iters: int):
    """Index-only resample of one population ``w [N]`` with a scalar
    ``seed``.  Returns ``ancestors int32[N]``."""
    anc = _rows("rejection", w.unsqueeze(0), None, seed.reshape(1), max_iters)
    rejection.launches += w.is_cuda
    return anc[0]


@kernel_wrapper(plane_instance("rejection_rows_kernel", True, state=1))
def rejection_fused_batch(w: torch.Tensor, state: torch.Tensor, seeds: torch.Tensor,
                          max_iters: int):
    """Fused resample + state copy over a bank: ``w [S, N]``, ``state
    [S, D, N]`` of the same plane dtype, ``seeds [S]``.  Returns ``(ancestors int32[S, N], state'
    [S, D, N])``; row ``s`` equals the single-row call with ``seeds[s]``."""
    result = _rows("rejection_fused_batch", w, state, seeds, max_iters)
    rejection_fused_batch.launches += w.is_cuda
    return result


@kernel_wrapper(plane_instance("rejection_rows_kernel", True, state=1))
def rejection_fused(w: torch.Tensor, state: torch.Tensor, seed: torch.Tensor, max_iters: int):
    """Fused resample + state copy of one population: ``w [N]``, ``state
    [D, N]``, a scalar ``seed``.  Returns ``(ancestors int32[N], state' [D,
    N])``."""
    anc, out = _rows("rejection_fused", w.unsqueeze(0), state.unsqueeze(0), seed.reshape(1),
                     max_iters)
    rejection_fused.launches += w.is_cuda
    return anc[0], out[0]


@kernel_wrapper(plane_instance("rejection_step_rows_kernel", state=1))
def rejection_step_rows(lw: torch.Tensor, state: torch.Tensor, seeds: torch.Tensor,
                        max_iters: int, thr: float):
    """Fused SMC step over a bank of log-weights ``[S, N]`` (a plane dtype;
    the chains run on ``exp(lw - m)`` requantised to it): each row takes
    its own resample decision ``ess_norm < thr``.  Returns ``(ancestors
    int32[S, N], state' [S, D, N], stats f32[S, 4])``."""
    result = _step("rejection_step_rows", lw, state, seeds, max_iters, thr)
    rejection_step_rows.launches += lw.is_cuda
    return result


@kernel_wrapper(plane_instance("rejection_step_rows_kernel", state=1))
def rejection_step(lw: torch.Tensor, state: torch.Tensor, seed: torch.Tensor, max_iters: int,
                   thr: float):
    """Fused SMC step of one population: ``lw [N]``, ``state [D, N]``.
    Returns ``(ancestors int32[N], state' [D, N], stats f32[4])``."""
    anc, out, stats = _step("rejection_step", lw.unsqueeze(0), state.unsqueeze(0),
                            seed.reshape(1), max_iters, thr)
    rejection_step.launches += lw.is_cuda
    return anc[0], out[0], stats[0]


WRAPPERS = (rejection, rejection_batch, rejection_fused, rejection_fused_batch,
            rejection_step, rejection_step_rows)


def reset_launch_counts():
    """Set every wrapper's ``launches`` count to 0."""
    for fn in WRAPPERS:
        fn.launches = 0


reset_launch_counts()
