"""Launch wrappers of the Metropolis CUDA kernels, one per TPU kernel (after
``repro.kernels.metropolis.metropolis``):

    metropolis              <- metropolis_pallas              (kernel: rows<false>, S = 1)
    metropolis_batch        <- metropolis_pallas_batch        (kernel: rows<false>)
    metropolis_fused        <- metropolis_pallas_fused        (kernel: rows<true>, S = 1)
    metropolis_fused_batch  <- metropolis_pallas_fused_batch  (kernel: rows<true>)
    metropolis_step         <- metropolis_pallas_step         (kernel: step_rows, S = 1)
    metropolis_step_rows    <- metropolis_pallas_step_rows    (kernel: step_rows)

Each wrapper takes weights (or log-weights) and state of one plane dtype,
float32, bfloat16 or float16 (``common.PLANE_DTYPES``), and launches the
kernel's instance for that word; the ancestors are int32 and the stats
float32 at every dtype.  It checks device, dtype, shape and contiguity,
allocates its
outputs (and the step kernel's scratch) with ``torch.empty``, launches on
``torch.cuda.current_stream()`` and adds one to its ``launches`` count where
it launches.  On CPU tensors it runs the plain version (``ref.py``) and
counts nothing; on a CUDA tensor it launches the kernel or raises.

Seeds (uint32 values in ``int64``) may come from the host: they are moved to
the weights' device as the int32 bit patterns the kernels read as
``uint32_t``.  The port's limits are those of its index arithmetic: N <=
2**30, N % 1024 == 0, S·N < 2**31; the TPU kernels' VMEM cap on N has no
counterpart here (the weights are read from L2 and HBM).
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
    kernel_wrapper,
    plane_instance,
    state_bytes,
    step_buffers,
)
from repro_torch.kernels.metropolis.ref import metropolis_rows_ref, metropolis_step_rows_ref

SOURCE = "metropolis/csrc/metropolis.cu"
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = load(SOURCE)
    if not getattr(lib, "_bound", False):
        lib.metropolis_rows.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
        lib.metropolis_rows.restype = _I
        lib.metropolis_fused_rows.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        lib.metropolis_fused_rows.restype = _I
        lib.metropolis_step_grid.argtypes = [_I, _I, _I, _I, ctypes.POINTER(_I)]
        lib.metropolis_step_grid.restype = _I
        lib.metropolis_step_rows.argtypes = [
            _P, _P, _P, ctypes.c_float, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
        ]
        lib.metropolis_step_rows.restype = _I
        lib._bound = True
    return lib


def _check(who: str, w, state, seeds, num_iters):
    """Validate a bank call; returns ``(S, N, D)``."""
    if isinstance(num_iters, bool) or not isinstance(num_iters, int) or num_iters < 1:
        raise ValueError(f"{who}: num_iters must be a positive int; got {num_iters!r}")
    return check_bank(who, w, state, seeds, PLANE_DTYPES)


def _launch_rows(w, state, seeds, num_iters, who):
    s, n, d = _check(who, w, state, seeds, num_iters)
    sd = device_seeds(seeds, w.device)
    anc = torch.empty((s, n), dtype=torch.int32, device=w.device)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    code = PLANE_CODES[w.dtype]
    if state is None:
        check_launch(_lib().metropolis_rows(
            w.data_ptr(), sd.data_ptr(), anc.data_ptr(), s, n, num_iters, code, stream), who)
        return anc
    out = torch.empty_like(state)
    check_launch(_lib().metropolis_fused_rows(
        w.data_ptr(), state.data_ptr(), sd.data_ptr(), anc.data_ptr(), out.data_ptr(),
        s, n, d, num_iters, state_bytes(state), code, stream), who)
    return anc, out


def _launch_step(lw, state, seeds, num_iters, thr, who):
    s, n, d = _check(who, lw, state, seeds, num_iters)
    lib = _lib()
    code, sb = PLANE_CODES[lw.dtype], state_bytes(state)
    g, anc, out, stats, scratch = step_buffers(
        lambda rows, n_, blocks: lib.metropolis_step_grid(rows, n_, sb, code, blocks),
        who, lw, state, num_iters)
    sd = device_seeds(seeds, lw.device)
    stream = torch.cuda.current_stream(lw.device).cuda_stream
    check_launch(lib.metropolis_step_rows(
        lw.data_ptr(), state.data_ptr(), sd.data_ptr(), float(thr), anc.data_ptr(),
        out.data_ptr(), stats.data_ptr(), scratch.data_ptr(), s, n, d, num_iters, g, sb, code,
        stream), who)
    return anc, out, stats


def _rows(who, w, state, seeds, num_iters):
    """One bank call of ``metropolis_rows_kernel``: the kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if not w.is_cuda:
        _check(who, w, state, seeds, num_iters)
        return metropolis_rows_ref(w, state, seeds, num_iters)
    return _launch_rows(w, state, seeds, num_iters, who)


def _step(who, lw, state, seeds, num_iters, thr):
    if not lw.is_cuda:
        _check(who, lw, state, seeds, num_iters)
        return metropolis_step_rows_ref(lw, state, seeds, num_iters, thr)
    return _launch_step(lw, state, seeds, num_iters, thr, who)


@kernel_wrapper(plane_instance("metropolis_rows_kernel", False, state=0))
def metropolis_batch(w: torch.Tensor, seeds: torch.Tensor, num_iters: int):
    """Index-only resample of a bank ``w [S, N]`` (a plane dtype) with one seed per row
    ``[S]``.  Returns ``ancestors int32[S, N]``; row ``s`` equals
    ``metropolis(w[s], seeds[s], num_iters)``."""
    anc = _rows("metropolis_batch", w, None, seeds, num_iters)
    metropolis_batch.launches += w.is_cuda
    return anc


@kernel_wrapper(plane_instance("metropolis_rows_kernel", False, state=0))
def metropolis(w: torch.Tensor, seed: torch.Tensor, num_iters: int):
    """Index-only resample of one population ``w [N]`` with a scalar
    ``seed``.  Returns ``ancestors int32[N]``."""
    anc = _rows("metropolis", w.unsqueeze(0), None, seed.reshape(1), num_iters)
    metropolis.launches += w.is_cuda
    return anc[0]


@kernel_wrapper(plane_instance("metropolis_rows_kernel", True, state=1))
def metropolis_fused_batch(w: torch.Tensor, state: torch.Tensor, seeds: torch.Tensor,
                           num_iters: int):
    """Fused resample + state copy over a bank: ``w [S, N]``, ``state
    [S, D, N]`` of the same plane dtype, ``seeds [S]``.  Returns ``(ancestors int32[S, N], state'
    [S, D, N])``; row ``s`` equals the single-row call with ``seeds[s]``."""
    result = _rows("metropolis_fused_batch", w, state, seeds, num_iters)
    metropolis_fused_batch.launches += w.is_cuda
    return result


@kernel_wrapper(plane_instance("metropolis_rows_kernel", True, state=1))
def metropolis_fused(w: torch.Tensor, state: torch.Tensor, seed: torch.Tensor,
                     num_iters: int):
    """Fused resample + state copy of one population: ``w [N]``, ``state
    [D, N]``, a scalar ``seed``.  Returns ``(ancestors int32[N], state' [D,
    N])``."""
    anc, out = _rows("metropolis_fused", w.unsqueeze(0), state.unsqueeze(0),
                     seed.reshape(1), num_iters)
    metropolis_fused.launches += w.is_cuda
    return anc[0], out[0]


@kernel_wrapper(plane_instance("metropolis_step_rows_kernel", state=1))
def metropolis_step_rows(lw: torch.Tensor, state: torch.Tensor, seeds: torch.Tensor,
                         num_iters: int, thr: float):
    """Fused SMC step over a bank of log-weights ``[S, N]`` (a plane dtype;
    the sweep runs on ``exp(lw - m)`` requantised to it): each row takes
    its own resample decision ``ess_norm < thr``.  Returns ``(ancestors
    int32[S, N], state' [S, D, N], stats f32[S, 4])``."""
    result = _step("metropolis_step_rows", lw, state, seeds, num_iters, thr)
    metropolis_step_rows.launches += lw.is_cuda
    return result


@kernel_wrapper(plane_instance("metropolis_step_rows_kernel", state=1))
def metropolis_step(lw: torch.Tensor, state: torch.Tensor, seed: torch.Tensor,
                    num_iters: int, thr: float):
    """Fused SMC step of one population: ``lw [N]``, ``state [D, N]``.
    Returns ``(ancestors int32[N], state' [D, N], stats f32[4])``."""
    anc, out, stats = _step("metropolis_step", lw.unsqueeze(0), state.unsqueeze(0),
                            seed.reshape(1), num_iters, thr)
    metropolis_step.launches += lw.is_cuda
    return anc[0], out[0], stats[0]


WRAPPERS = (metropolis, metropolis_batch, metropolis_fused, metropolis_fused_batch,
            metropolis_step, metropolis_step_rows)


def reset_launch_counts():
    """Set every wrapper's ``launches`` count to 0."""
    for fn in WRAPPERS:
        fn.launches = 0


reset_launch_counts()
