"""Launch wrappers of the Megopolis CUDA kernels, one per TPU kernel (after
``repro.kernels.megopolis.megopolis``):

    megopolis             <- megopolis_pallas             (kernel: fused_rows<false>, S = 1)
    megopolis_batch       <- megopolis_pallas_batch       (kernel: fused_rows<false>)
    megopolis_rows        <- megopolis_pallas, vmapped    (kernel: fused_rows<false>)
    megopolis_fused       <- megopolis_pallas_fused       (kernel: fused_rows<true>, S = 1)
    megopolis_fused_rows  <- megopolis_pallas_fused_rows  (kernel: fused_rows<true>)
    megopolis_step        <- megopolis_pallas_step        (kernel: step_rows, S = 1)
    megopolis_step_rows   <- megopolis_pallas_step_rows   (kernel: step_rows)

Each wrapper takes weights (or log-weights) and state of one plane dtype,
float32, bfloat16 or float16 (``common.PLANE_DTYPES``), and launches the
kernel's instance for that word; the ancestors are int32 and the stats
float32 at every dtype.  Beside float32 weights the state may also be a
4-byte integer (``common.INT_STATE_DTYPES``: the token buffer of SMC
decoding), which the float32 instance copies as its words, bit for bit;
beside a 2-byte plane an integer state raises ``ValueError`` on the card
(``common.INT_STATE_ITEM``) and is never cast.  It checks device, dtype, shape and contiguity (and,
for the index-only and fused kernels, that the weights start on a 16-byte
boundary, as their bulk copies need), allocates its
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
from repro_torch.kernels.common import (
    PLANE_CODES,
    PLANE_DTYPES,
    as_state_words,
    check_aligned,
    check_bank,
    check_launch,
    device_seeds,
    kernel_wrapper,
    plane_instance,
    step_buffers,
)
from repro_torch.kernels.megopolis.ref import (
    megopolis_fused_rows_ref,
    megopolis_rows_ref,
    megopolis_step_rows_ref,
)

SOURCE = "megopolis/csrc/megopolis.cu"
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = load(SOURCE)
    if not getattr(lib, "_bound", False):
        lib.megopolis_rows.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
        lib.megopolis_rows.restype = _I
        lib.megopolis_fused_rows.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
        lib.megopolis_fused_rows.restype = _I
        lib.megopolis_step_grid.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
        lib.megopolis_step_grid.restype = _I
        lib.megopolis_step_rows.argtypes = [
            _P, _P, _P, _P, ctypes.c_float, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
        ]
        lib.megopolis_step_rows.restype = _I
        lib._bound = True
    return lib


def _check_bank(who: str, w, state, offsets, seeds):
    """Validate a bank call (``state`` None for the index-only kernel);
    returns ``(S, N, D, B)``."""
    s, n, d = check_bank(who, w, state, seeds, PLANE_DTYPES, int_state=True)
    if offsets.ndim != 2 or offsets.shape[0] != s or offsets.shape[1] < 1:
        raise ValueError(f"{who}: offsets must be int32[S, B>=1]; got {list(offsets.shape)}")
    if not offsets.is_cuda and offsets.numel() and (offsets.min() < 0 or offsets.max() >= n):
        raise ValueError(f"{who}: offsets must lie in [0, {n})")
    return s, n, d, offsets.shape[1]


def _device_offsets(w, offsets):
    return offsets.to(device=w.device, dtype=torch.int32).contiguous()


def _launch_rows(w, offsets, seeds, who):
    s, n, _, b = _check_bank(who, w, None, offsets, seeds)
    check_aligned(who, w)
    offs, sd = _device_offsets(w, offsets), device_seeds(seeds, w.device)
    anc = torch.empty((s, n), dtype=torch.int32, device=w.device)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    check_launch(_lib().megopolis_rows(
        w.data_ptr(), offs.data_ptr(), sd.data_ptr(), anc.data_ptr(), s, n, b,
        PLANE_CODES[w.dtype], stream), who)
    return anc


def _launch_fused(w, state, offsets, seeds, who):
    s, n, d, b = _check_bank(who, w, state, offsets, seeds)
    check_aligned(who, w)
    offs, sd = _device_offsets(w, offsets), device_seeds(seeds, w.device)
    words = as_state_words(state)
    anc = torch.empty((s, n), dtype=torch.int32, device=w.device)
    out = torch.empty_like(words)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    check_launch(_lib().megopolis_fused_rows(
        w.data_ptr(), words.data_ptr(), offs.data_ptr(), sd.data_ptr(),
        anc.data_ptr(), out.data_ptr(), s, n, d, b, PLANE_CODES[w.dtype], stream), who)
    return anc, out.view(state.dtype)


def _launch_step(lw, state, offsets, seeds, thr, who):
    s, n, d, b = _check_bank(who, lw, state, offsets, seeds)
    lib = _lib()
    code = PLANE_CODES[lw.dtype]
    words = as_state_words(state)
    g, anc, out, stats, scratch = step_buffers(
        lambda rows, n_, blocks: lib.megopolis_step_grid(rows, n_, code, blocks),
        who, lw, words, b)
    offs, sd = _device_offsets(lw, offsets), device_seeds(seeds, lw.device)
    stream = torch.cuda.current_stream(lw.device).cuda_stream
    check_launch(lib.megopolis_step_rows(
        lw.data_ptr(), words.data_ptr(), offs.data_ptr(), sd.data_ptr(), float(thr),
        anc.data_ptr(), out.data_ptr(), stats.data_ptr(), scratch.data_ptr(),
        s, n, d, b, g, code, stream), who)
    return anc, out.view(state.dtype), stats


@kernel_wrapper(plane_instance("megopolis_fused_rows_kernel", False))
def megopolis_rows(w: torch.Tensor, offsets: torch.Tensor, seeds: torch.Tensor):
    """Index-only resample of a bank: ``w [S, N]`` (a plane dtype), per-row ``offsets
    int32[S, B]`` and ``seeds [S]``.  Returns ``ancestors int32[S, N]``;
    row ``s`` equals ``megopolis(w[s], offsets[s], seeds[s])``."""
    if not w.is_cuda:
        _check_bank("megopolis_rows", w, None, offsets, seeds)
        return megopolis_rows_ref(w, offsets, seeds)
    anc = _launch_rows(w, offsets, seeds, "megopolis_rows")
    megopolis_rows.launches += 1
    return anc


@kernel_wrapper(plane_instance("megopolis_fused_rows_kernel", False))
def megopolis_batch(w: torch.Tensor, offsets: torch.Tensor, seeds: torch.Tensor):
    """Index-only resample of a bank under ONE offset table ``int32[B]``
    shared by every row, with per-row ``seeds [S]``.  Returns
    ``ancestors int32[S, N]``."""
    args = (w, offsets.reshape(1, -1).expand(w.shape[0], -1), seeds)
    if not w.is_cuda:
        _check_bank("megopolis_batch", w, None, *args[1:])
        return megopolis_rows_ref(*args)
    anc = _launch_rows(*args, "megopolis_batch")
    megopolis_batch.launches += 1
    return anc


@kernel_wrapper(plane_instance("megopolis_fused_rows_kernel", False))
def megopolis(w: torch.Tensor, offsets: torch.Tensor, seed: torch.Tensor):
    """Index-only resample of one population: ``w [N]``, ``offsets
    int32[B]``, a scalar ``seed``.  Returns ``ancestors int32[N]``."""
    args = (w.unsqueeze(0), offsets.reshape(1, -1), seed.reshape(1))
    if not w.is_cuda:
        _check_bank("megopolis", w.unsqueeze(0), None, *args[1:])
        return megopolis_rows_ref(*args)[0]
    anc = _launch_rows(*args, "megopolis")
    megopolis.launches += 1
    return anc[0]


@kernel_wrapper(plane_instance("megopolis_fused_rows_kernel", True))
def megopolis_fused_rows(w: torch.Tensor, state: torch.Tensor, offsets: torch.Tensor,
                         seeds: torch.Tensor):
    """Fused resample + state copy over a bank: ``w [S, N]``, ``state
    [S, D, N]`` of the same plane dtype (or int32 beside float32
    weights), per-row ``offsets int32[S, B]`` and ``seeds [S]``.  Returns
    ``(ancestors int32[S, N], state' [S, D, N])``; row ``s`` equals the
    single-row call with ``offsets[s]``, ``seeds[s]``."""
    if not w.is_cuda:
        _check_bank("megopolis_fused_rows", w, state, offsets, seeds)
        return megopolis_fused_rows_ref(w, state, offsets, seeds)
    result = _launch_fused(w, state, offsets, seeds, "megopolis_fused_rows")
    megopolis_fused_rows.launches += 1
    return result


@kernel_wrapper(plane_instance("megopolis_fused_rows_kernel", True))
def megopolis_fused(w: torch.Tensor, state: torch.Tensor, offsets: torch.Tensor,
                    seed: torch.Tensor):
    """Fused resample + state copy of one population: ``w [N]``, ``state
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


@kernel_wrapper(plane_instance("megopolis_step_rows_kernel"))
def megopolis_step_rows(lw: torch.Tensor, state: torch.Tensor, offsets: torch.Tensor,
                        seeds: torch.Tensor, thr: float):
    """Fused SMC step over a bank of log-weights ``[S, N]`` (a plane dtype;
    the sweep runs on ``exp(lw - m)`` requantised to it): each row takes
    its own resample decision ``ess_norm < thr``.  Returns ``(ancestors
    int32[S, N], state' [S, D, N], stats f32[S, 4])``."""
    if not lw.is_cuda:
        _check_bank("megopolis_step_rows", lw, state, offsets, seeds)
        return megopolis_step_rows_ref(lw, state, offsets, seeds, thr)
    result = _launch_step(lw, state, offsets, seeds, thr, "megopolis_step_rows")
    megopolis_step_rows.launches += 1
    return result


@kernel_wrapper(plane_instance("megopolis_step_rows_kernel"))
def megopolis_step(lw: torch.Tensor, state: torch.Tensor, offsets: torch.Tensor,
                   seed: torch.Tensor, thr: float):
    """Fused SMC step of one population: ``lw [N]``, ``state [D, N]``.
    Returns ``(ancestors int32[N], state' [D, N], stats f32[4])``."""
    args = (lw.unsqueeze(0), state.unsqueeze(0), offsets.reshape(1, -1), seed.reshape(1))
    if not lw.is_cuda:
        _check_bank("megopolis_step", *args)
        anc, out, stats = megopolis_step_rows_ref(*args, thr)
    else:
        anc, out, stats = _launch_step(*args, thr, "megopolis_step")
        megopolis_step.launches += 1
    return anc[0], out[0], stats[0]


WRAPPERS = (megopolis, megopolis_batch, megopolis_rows, megopolis_fused,
            megopolis_fused_rows, megopolis_step, megopolis_step_rows)


def reset_launch_counts():
    """Set every wrapper's ``launches`` count to 0."""
    for fn in WRAPPERS:
        fn.launches = 0


reset_launch_counts()
