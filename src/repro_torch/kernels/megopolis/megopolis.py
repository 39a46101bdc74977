"""Launch wrappers of the Megopolis CUDA kernels, one per TPU kernel on the
particle-filter path (after ``repro.kernels.megopolis.megopolis``):

    megopolis_fused       <- megopolis_pallas_fused       (kernel: fused_rows, S = 1)
    megopolis_fused_rows  <- megopolis_pallas_fused_rows  (kernel: fused_rows)
    megopolis_step        <- megopolis_pallas_step        (kernel: step_rows, S = 1)
    megopolis_step_rows   <- megopolis_pallas_step_rows   (kernel: step_rows)

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs (and the step kernel's scratch) with ``torch.empty``, launches on
``torch.cuda.current_stream()`` and adds one to its ``launches`` count where
it launches.  On CPU tensors it runs the plain version (``ref.py``) and
counts nothing; on a CUDA tensor it launches the kernel or raises.

Offsets ``int32[..., B]`` and seeds (uint32 values in ``int64``) may come
from the host: they are moved to the weights' device, seeds as the int32
bit patterns the kernels read as ``uint32_t``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.common import MAX_PARTICLES, TILE, seed_bits
from repro_torch.kernels.megopolis.ref import megopolis_fused_rows_ref, megopolis_step_rows_ref
from repro_torch.resilience.errors import KernelLaunchError

SOURCE = "megopolis/csrc/megopolis.cu"
#: Rows of one step launch: the per-row shift and flags sit in shared memory.
MAX_STEP_ROWS = 4096
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = load(SOURCE)
    if not getattr(lib, "_bound", False):
        lib.megopolis_fused_rows.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
        lib.megopolis_fused_rows.restype = _I
        lib.megopolis_step_grid.argtypes = [_I, _I, ctypes.POINTER(_I)]
        lib.megopolis_step_grid.restype = _I
        lib.megopolis_step_rows.argtypes = [
            _P, _P, _P, _P, ctypes.c_float, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
        ]
        lib.megopolis_step_rows.restype = _I
        lib._bound = True
    return lib


def _check(err: int, who: str):
    if err != 0:
        raise KernelLaunchError(f"{who}: CUDA error {err} at launch")


def _check_bank(who: str, w, state, offsets, seeds):
    """Validate a bank call; returns ``(S, N, D, B)``."""
    if w.dtype != torch.float32 or w.ndim != 2:
        raise ValueError(f"{who}: weights must be float32[S, N]; got {w.dtype}{list(w.shape)}")
    s, n = w.shape
    if n % TILE != 0 or not 0 < n <= MAX_PARTICLES:
        raise ValueError(f"{who} requires 0 < N <= 2**30 and N % {TILE} == 0; got N={n}")
    if s * n >= 1 << 31:
        raise ValueError(f"{who}: S·N must stay below 2**31 (int32 indices); got {s}·{n}")
    if state.ndim != 3 or state.shape[0] != s or state.shape[2] != n:
        raise ValueError(f"{who}: state must be [S, D, N] = [{s}, D, {n}]; got {list(state.shape)}")
    if offsets.ndim != 2 or offsets.shape[0] != s or offsets.shape[1] < 1:
        raise ValueError(f"{who}: offsets must be int32[S, B>=1]; got {list(offsets.shape)}")
    if not offsets.is_cuda and offsets.numel() and (offsets.min() < 0 or offsets.max() >= n):
        raise ValueError(f"{who}: offsets must lie in [0, {n})")
    if seeds.shape != (s,):
        raise ValueError(f"{who}: seeds must be [S]; got {list(seeds.shape)}")
    if w.is_cuda:
        if state.device != w.device:
            raise ValueError(f"{who}: state on {state.device}, weights on {w.device}")
        if state.dtype != torch.float32:
            raise ValueError(f"{who}: the CUDA kernel copies float32 state; got {state.dtype}")
        if not (w.is_contiguous() and state.is_contiguous()):
            raise ValueError(f"{who}: weights and state must be contiguous")
    elif state.is_cuda:
        raise ValueError(f"{who}: state on {state.device}, weights on the CPU")
    return s, n, state.shape[1], offsets.shape[1]


def _device_tables(w, offsets, seeds):
    offs = offsets.to(device=w.device, dtype=torch.int32).contiguous()
    return offs, seed_bits(seeds.to(torch.int64)).to(w.device)


def _launch_fused(w, state, offsets, seeds, who):
    s, n, d, b = _check_bank(who, w, state, offsets, seeds)
    offs, sd = _device_tables(w, offsets, seeds)
    anc = torch.empty((s, n), dtype=torch.int32, device=w.device)
    out = torch.empty_like(state)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    _check(_lib().megopolis_fused_rows(
        w.data_ptr(), state.data_ptr(), offs.data_ptr(), sd.data_ptr(),
        anc.data_ptr(), out.data_ptr(), s, n, d, b, stream), who)
    return anc, out


def _launch_step(lw, state, offsets, seeds, thr, who):
    s, n, d, b = _check_bank(who, lw, state, offsets, seeds)
    if s > MAX_STEP_ROWS:
        raise ValueError(f"{who}: at most {MAX_STEP_ROWS} rows per step launch; got {s}")
    lib = _lib()
    blocks = _I(0)
    with torch.cuda.device(lw.device):
        _check(lib.megopolis_step_grid(s, n, ctypes.byref(blocks)), who)
    g = blocks.value
    offs, sd = _device_tables(lw, offsets, seeds)
    anc = torch.empty((s, n), dtype=torch.int32, device=lw.device)
    out = torch.empty_like(state)
    stats = torch.empty((s, 4), dtype=torch.float32, device=lw.device)
    scratch = torch.empty(s * g * 5 + s * b + s * n, dtype=torch.float32, device=lw.device)
    stream = torch.cuda.current_stream(lw.device).cuda_stream
    _check(lib.megopolis_step_rows(
        lw.data_ptr(), state.data_ptr(), offs.data_ptr(), sd.data_ptr(), float(thr),
        anc.data_ptr(), out.data_ptr(), stats.data_ptr(), scratch.data_ptr(),
        s, n, d, b, g, stream), who)
    return anc, out, stats


def megopolis_fused_rows(w: torch.Tensor, state: torch.Tensor, offsets: torch.Tensor,
                         seeds: torch.Tensor):
    """Fused resample + state copy over a bank: ``w f32[S, N]``, ``state
    [S, D, N]``, per-row ``offsets int32[S, B]`` and ``seeds [S]``.  Returns
    ``(ancestors int32[S, N], state' [S, D, N])``; row ``s`` equals the
    single-row call with ``offsets[s]``, ``seeds[s]``."""
    if not w.is_cuda:
        _check_bank("megopolis_fused_rows", w, state, offsets, seeds)
        return megopolis_fused_rows_ref(w, state, offsets, seeds)
    result = _launch_fused(w, state, offsets, seeds, "megopolis_fused_rows")
    megopolis_fused_rows.launches += 1
    return result


def megopolis_fused(w: torch.Tensor, state: torch.Tensor, offsets: torch.Tensor,
                    seed: torch.Tensor):
    """Fused resample + state copy of one population: ``w f32[N]``, ``state
    [D, N]``, ``offsets int32[B]``, a scalar ``seed``.  Returns
    ``(ancestors int32[N], state' [D, N])``."""
    args = (w.unsqueeze(0), state.unsqueeze(0), offsets.reshape(1, -1), seed.reshape(1))
    if not w.is_cuda:
        _check_bank("megopolis_fused", *args)
        anc, out = megopolis_fused_rows_ref(*args)
    else:
        anc, out = _launch_fused(*args, "megopolis_fused")
        megopolis_fused.launches += 1
    return anc[0], out[0]


def megopolis_step_rows(lw: torch.Tensor, state: torch.Tensor, offsets: torch.Tensor,
                        seeds: torch.Tensor, thr: float):
    """Fused SMC step over a bank of log-weights ``f32[S, N]``: each row takes
    its own resample decision ``ess_norm < thr``.  Returns ``(ancestors
    int32[S, N], state' [S, D, N], stats f32[S, 4])``."""
    if not lw.is_cuda:
        _check_bank("megopolis_step_rows", lw, state, offsets, seeds)
        return megopolis_step_rows_ref(lw, state, offsets, seeds, thr)
    result = _launch_step(lw, state, offsets, seeds, thr, "megopolis_step_rows")
    megopolis_step_rows.launches += 1
    return result


def megopolis_step(lw: torch.Tensor, state: torch.Tensor, offsets: torch.Tensor,
                   seed: torch.Tensor, thr: float):
    """Fused SMC step of one population: ``lw f32[N]``, ``state [D, N]``.
    Returns ``(ancestors int32[N], state' [D, N], stats f32[4])``."""
    args = (lw.unsqueeze(0), state.unsqueeze(0), offsets.reshape(1, -1), seed.reshape(1))
    if not lw.is_cuda:
        _check_bank("megopolis_step", *args)
        anc, out, stats = megopolis_step_rows_ref(*args, thr)
    else:
        anc, out, stats = _launch_step(*args, thr, "megopolis_step")
        megopolis_step.launches += 1
    return anc[0], out[0], stats[0]


WRAPPERS = (megopolis_fused, megopolis_fused_rows, megopolis_step, megopolis_step_rows)


def reset_launch_counts():
    """Set every wrapper's ``launches`` count to 0."""
    for fn in WRAPPERS:
        fn.launches = 0


reset_launch_counts()
