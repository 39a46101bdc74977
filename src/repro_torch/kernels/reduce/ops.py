"""The row reduction as the AIS schedule calls it: ``logsumexp`` over the
last axis of ``[N]`` or ``[..., N]``, one launch of ``logsumexp_rows`` on
the rows flattened to ``[S, N]``."""

from __future__ import annotations

import torch

from repro_torch.kernels.reduce.reduce import logsumexp_rows


def logsumexp(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """``log Σ exp(x)`` over the last axis, in ``logsumexp_rows``' order: a
    row gives the same bits whatever the leading axes hold."""
    lead = x.shape[:-1]
    out = logsumexp_rows(x.reshape(-1, x.shape[-1]).contiguous()).reshape(lead)
    return out.unsqueeze(-1) if keepdim else out
