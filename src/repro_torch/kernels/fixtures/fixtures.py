"""Launch wrappers of the contract checks' fixture kernels, one per TPU
kernel (after ``repro.analysis.fixtures``):

    copy_launch  <- _copy_launch                    (kernel: copy_kernel)
    iota_launch  <- hbm_roundtrip's pallas_call     (kernel: iota_kernel)

The kernels are right; ``repro_torch.analysis.fixtures`` misuses them, two
chained copies where the contract allows one launch, the iota's output
indexing a gather outside any kernel, so that the checks have something to
catch.  Each wrapper checks its input, allocates its output with
``torch.empty``, launches on ``torch.cuda.current_stream()`` and adds one to
its ``launches`` count where it launches.  On CPU tensors it runs the plain
version (``ref.py``) and counts nothing; on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.common import check_launch, kernel_wrapper
from repro_torch.kernels.fixtures.ref import copy_ref, iota_ref

SOURCE = "fixtures/csrc/fixtures.cu"
_P = ctypes.c_void_p
_L = ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = load(SOURCE)
    if not getattr(lib, "_bound", False):
        lib.fixture_copy.argtypes = [_P, _P, _L, _P]
        lib.fixture_copy.restype = ctypes.c_int
        lib.fixture_iota.argtypes = [_P, _L, _P]
        lib.fixture_iota.restype = ctypes.c_int
        lib._bound = True
    return lib


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def same_phase_empty(x: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor shaped as ``x`` that starts at ``x``'s offset
    modulo 16 bytes (a fresh allocation is 16-byte aligned), so that
    ``copy_kernel`` moves whole 16-byte vectors between the two."""
    phase = x.data_ptr() % 16 // x.element_size()
    return torch.empty(x.numel() + phase, dtype=x.dtype, device=x.device)[phase:].view(x.shape)


@kernel_wrapper("copy_kernel")
def copy_launch(x: torch.Tensor) -> torch.Tensor:
    """``o = x`` for a float32 tensor of any shape, in one launch."""
    if x.dtype != torch.float32:
        raise ValueError(f"copy_launch: x must be float32; got {x.dtype}")
    if not x.is_cuda:
        return copy_ref(x)
    if not x.is_contiguous():
        raise ValueError("copy_launch: x must be contiguous")
    out = same_phase_empty(x)
    check_launch(_lib().fixture_copy(x.data_ptr(), out.data_ptr(), x.numel(), _stream(x)),
                 "copy_launch")
    copy_launch.launches += 1
    return out


@kernel_wrapper("iota_kernel")
def iota_launch(w: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """``int32[1, N] = 0..N-1`` on the device of ``w [N]``, in one launch;
    into ``out`` where given (a contiguous ``int32[1, N]`` on that device,
    which may be a view at any 4-byte offset), else into a new tensor."""
    if w.ndim != 1 or not 0 < w.shape[0] < 1 << 31:
        raise ValueError(f"iota_launch: w must be [N] with 0 < N < 2**31; got {list(w.shape)}")
    n = w.shape[0]
    if out is not None and (out.shape != (1, n) or out.dtype != torch.int32
                            or out.device != w.device or not out.is_contiguous()):
        raise ValueError(f"iota_launch: out must be a contiguous int32[1, {n}] on {w.device}; "
                         f"got {out.dtype}{list(out.shape)} on {out.device}")
    if not w.is_cuda:
        return iota_ref(n, w.device) if out is None else out.copy_(iota_ref(n, w.device))
    if out is None:
        out = torch.empty((1, n), dtype=torch.int32, device=w.device)
    check_launch(_lib().fixture_iota(out.data_ptr(), n, _stream(w)), "iota_launch")
    iota_launch.launches += 1
    return out


WRAPPERS = (copy_launch, iota_launch)


def reset_launch_counts():
    """Set every wrapper's ``launches`` count to 0."""
    for fn in WRAPPERS:
        fn.launches = 0


reset_launch_counts()
