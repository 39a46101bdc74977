"""Launch wrappers of the prefix-sum scan kernel (after
``repro.kernels.prefix_sum.prefix_sum``), and the library binding and checks
that ``search.py`` and ``step.py`` share:

    prefix_sum_rows  <- prefix_sum_pallas  (kernel: prefix_scan_rows_kernel<T>, a bank of S
                                            rows; the JAX package scans one row per call)

The family's wrappers take banks only: one population is a bank of one row.
Compressed planes (DESIGN.md §14): only the scan's input travels in a plane
dtype (float32, bfloat16 or float16, ``common.PLANE_DTYPES``; the kernel's
instance of that word T); the CDF it emits is float32, and so are the
searches' CDFs and draws.  The searches copy state of any plane dtype, the
step takes log-weights and state of one.
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
from repro_torch.kernels.common import (
    PLANE_CODES,
    PLANE_DTYPES,
    TILE,
    check_bank,
    check_launch,
    kernel_wrapper,
    plane_instance,
)
from repro_torch.kernels.prefix_sum.ref import scan_rows_ref

SOURCE = "prefix_sum/csrc/prefix_sum.cu"
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = load(SOURCE)
    if not getattr(lib, "_bound", False):
        lib.prefix_scan_grid.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
        lib.prefix_scan_grid.restype = _I
        lib.prefix_scan_rows.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
        lib.prefix_scan_rows.restype = _I
        lib.prefix_search_rows.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                                           _I, _I, _I, _I, _I, _P]
        lib.prefix_search_rows.restype = _I
        lib.prefix_step_grid.argtypes = [_I, _I, _I, _I, _I, ctypes.POINTER(_I)]
        lib.prefix_step_grid.restype = _I
        lib.prefix_step_rows.argtypes = [
            _I, _P, _P, _P, _P, ctypes.c_float, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
        ]
        lib.prefix_step_rows.restype = _I
        lib._bound = True
    return lib


def check_rows(who: str, x: torch.Tensor, *like, state=None, planes=("float32",),
               state_planes=None):
    """Validate a bank call: ``x [S, N]`` of a dtype of ``planes``, each
    tensor of ``like`` (None skipped) ``f32[S, N]`` on ``x``'s device, and
    ``state [S, D, N]`` or None (on the card of ``x``'s dtype, or of one of
    ``state_planes``: ``common.check_bank``).  Returns ``(S, N, D)``."""
    s, n, d = check_bank(who, x, state, None, planes, state_planes)
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


@kernel_wrapper(plane_instance("prefix_scan_rows_kernel"))
def prefix_sum_rows(x: torch.Tensor) -> torch.Tensor:
    """The tiled inclusive scan of each row of ``x [S, N]`` (a plane dtype,
    each word upcast exactly), in one launch: ``f32[S, N]``."""
    who = "prefix_sum_rows"
    s, n, _ = check_rows(who, x, planes=PLANE_DTYPES)
    if not x.is_cuda:
        return scan_rows_ref(x)
    lib = _lib()
    code = PLANE_CODES[x.dtype]
    blocks = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        check_launch(lib.prefix_scan_grid(s, n, code, ctypes.byref(blocks)), who)
    y = torch.empty((s, n), dtype=torch.float32, device=x.device)
    tot = torch.empty(s * (n // TILE), dtype=torch.float32, device=x.device)
    check_launch(lib.prefix_scan_rows(x.data_ptr(), y.data_ptr(), tot.data_ptr(), s, n,
                                      blocks.value, code, stream(x)), who)
    prefix_sum_rows.launches += 1
    return y


WRAPPERS = (prefix_sum_rows,)


def reset_launch_counts():
    """Set every wrapper's ``launches`` count to 0."""
    for fn in WRAPPERS:
        fn.launches = 0


reset_launch_counts()
