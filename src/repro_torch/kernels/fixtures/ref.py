"""Plain PyTorch versions of the fixture kernels (``csrc/fixtures.cu``): a
copy into a new tensor and an ``arange``, the functions of
``repro.analysis.fixtures``' ``_copy_launch`` and of ``hbm_roundtrip``'s
kernel."""

from __future__ import annotations

import torch


def copy_ref(x: torch.Tensor) -> torch.Tensor:
    """``o = x`` into a new tensor."""
    out = torch.empty_like(x)
    out.copy_(x)
    return out


def iota_ref(n: int, device) -> torch.Tensor:
    """``int32[1, N] = 0..N-1``."""
    return torch.arange(n, dtype=torch.int32, device=device).reshape(1, n)
