"""Launch wrappers of the prefix-sum scan kernel (after
``repro.kernels.prefix_sum.prefix_sum``), and the library binding and checks
that ``search.py`` and ``step.py`` share:

    prefix_sum_rows  <- prefix_sum_pallas  (kernel: prefix_scan_rows_kernel, a bank of S
                                            rows; the JAX package scans one row per call)

The family's wrappers take banks only: one population is a bank of one row.
Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs and scratch with ``torch.empty``, launches on
``torch.cuda.current_stream()`` and adds one to its ``launches`` count where
it launches.  On CPU tensors it runs the plain version (``ref.py``) and
counts nothing; on a CUDA tensor it launches the kernel or raises.  The
port's limits are those of its index arithmetic: N <= 2**30, N % 1024 == 0,
S·N < 2**31; the TPU kernels' VMEM cap on N has no counterpart here.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.common import TILE, check_bank, check_launch, kernel_wrapper
from repro_torch.kernels.prefix_sum.ref import scan_rows_ref

SOURCE = "prefix_sum/csrc/prefix_sum.cu"
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = load(SOURCE)
    if not getattr(lib, "_bound", False):
        lib.prefix_scan_grid.argtypes = [_I, _I, ctypes.POINTER(_I)]
        lib.prefix_scan_grid.restype = _I
        lib.prefix_scan_rows.argtypes = [_P, _P, _P, _I, _I, _I, _P]
        lib.prefix_scan_rows.restype = _I
        lib.prefix_search_rows.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                                           _I, _I, _I, _I, _P]
        lib.prefix_search_rows.restype = _I
        lib.prefix_step_grid.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
        lib.prefix_step_grid.restype = _I
        lib.prefix_step_rows.argtypes = [
            _I, _P, _P, _P, _P, ctypes.c_float, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
        ]
        lib.prefix_step_rows.restype = _I
        lib._bound = True
    return lib


def check_rows(who: str, x: torch.Tensor, *like, state=None):
    """Validate a bank call: ``x f32[S, N]``, each tensor of ``like`` (None
    skipped) ``f32[S, N]`` on ``x``'s device, and ``state [S, D, N]`` or
    None.  Returns ``(S, N, D)``."""
    s, n, d = check_bank(who, x, state, None)
    for y in like:
        if y is None:
            continue
        if y.dtype != torch.float32 or tuple(y.shape) != (s, n) or y.device != x.device:
            raise ValueError(f"{who}: expected float32[{s}, {n}] on {x.device}; got "
                             f"{y.dtype}{list(y.shape)} on {y.device}")
        if y.is_cuda and not y.is_contiguous():
            raise ValueError(f"{who}: inputs must be contiguous")
    return s, n, d


def stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def ptr(x):
    """A tensor's device pointer, or None (a null pointer) for no tensor."""
    return None if x is None else x.data_ptr()


@kernel_wrapper("prefix_scan_rows_kernel")
def prefix_sum_rows(x: torch.Tensor) -> torch.Tensor:
    """The tiled inclusive scan of each row of ``x f32[S, N]``, in one
    launch: ``f32[S, N]``."""
    who = "prefix_sum_rows"
    s, n, _ = check_rows(who, x)
    if not x.is_cuda:
        return scan_rows_ref(x)
    lib = _lib()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        check_launch(lib.prefix_scan_grid(s, n, ctypes.byref(blocks)), who)
    y = torch.empty_like(x)
    tot = torch.empty(s * (n // TILE), dtype=torch.float32, device=x.device)
    check_launch(lib.prefix_scan_rows(x.data_ptr(), y.data_ptr(), tot.data_ptr(), s, n,
                                      blocks.value, stream(x)), who)
    prefix_sum_rows.launches += 1
    return y


WRAPPERS = (prefix_sum_rows,)


def reset_launch_counts():
    """Set every wrapper's ``launches`` count to 0."""
    for fn in WRAPPERS:
        fn.launches = 0


reset_launch_counts()
