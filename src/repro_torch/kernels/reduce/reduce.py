"""Launch wrapper of the row reduction kernel, which has no TPU counterpart:

    logsumexp_rows  (kernel: logsumexp_rows_kernel)

It takes ``f32[S, N]``, checks device, dtype, shape and contiguity,
allocates its ``f32[S]`` output with ``torch.empty``, launches on
``torch.cuda.current_stream()`` and adds one to its ``launches`` count where
it launches.  On a CPU tensor it runs the plain version (``ref.py``) and
counts nothing; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.common import MAX_ROWS, check_launch, kernel_wrapper
from repro_torch.kernels.reduce.ref import logsumexp_rows_ref

SOURCE = "reduce/csrc/reduce.cu"
_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = load(SOURCE)
    if not getattr(lib, "_bound", False):
        lib.reduce_logsumexp_rows.argtypes = [_P, _P, ctypes.c_int, ctypes.c_longlong, _P]
        lib.reduce_logsumexp_rows.restype = ctypes.c_int
        lib._bound = True
    return lib


@kernel_wrapper("logsumexp_rows_kernel")
def logsumexp_rows(x: torch.Tensor) -> torch.Tensor:
    """``log Σ_i exp(x[s, i])`` of ``f32[S, N]`` -> ``f32[S]``, each row's
    adds in an order that depends on N alone, so a bank row equals the same
    row reduced alone, bit for bit."""
    if x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError(f"logsumexp_rows: x must be float32[S, N]; got {x.dtype}{list(x.shape)}")
    s, n = x.shape
    if not 0 < s <= MAX_ROWS or n < 1:
        raise ValueError(f"logsumexp_rows: 1 to {MAX_ROWS} rows of N >= 1; got {list(x.shape)}")
    if not x.is_cuda:
        return logsumexp_rows_ref(x)
    if not x.is_contiguous():
        raise ValueError("logsumexp_rows: x must be contiguous")
    out = torch.empty(s, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().reduce_logsumexp_rows(x.data_ptr(), out.data_ptr(), s, n,
                                           torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, "logsumexp_rows")
    logsumexp_rows.launches += 1
    return out


WRAPPERS = (logsumexp_rows,)


def reset_launch_counts():
    """Set every wrapper's ``launches`` count to 0."""
    for fn in WRAPPERS:
        fn.launches = 0


reset_launch_counts()
