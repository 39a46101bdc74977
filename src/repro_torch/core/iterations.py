"""Iteration-count selection (paper eq. 3), after ``repro.core.iterations``.

    B = ceil( log(eps) / log(1 - E(w) / max(w)) )

In eager PyTorch the weights are always concrete, so ``"auto"`` resolves to
a Python int with one ``.item()`` (the only point where a step waits on
the device).
"""

from __future__ import annotations

import math

import torch

from repro_torch import random as trandom


def select_iterations(weights: torch.Tensor, epsilon: float = 0.01) -> int:
    """Exact eq. (3) over ``weights[N]``; returns a Python int >= 1."""
    w = weights.to(torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    ratio = torch.clamp(w.mean() / torch.clamp(w.amax(), min=tiny), 1e-12, 1 - 1e-7)
    eps = torch.tensor(epsilon, dtype=torch.float32, device=w.device)
    b = torch.ceil(torch.log(eps) / torch.log1p(-ratio))
    return max(int(b.item()), 1)


def select_iterations_subsample(key: torch.Tensor, weights: torch.Tensor, epsilon: float = 0.01,
                                sample: int = 4096) -> int:
    """Eq. (3) from a uniform subsample of ``sample`` weights (with
    replacement, ``randint`` on the key), the production-mode estimator."""
    n = weights.shape[0]
    idx = trandom.randint(key, (min(sample, n),), 0, n, device=weights.device)
    return select_iterations(weights[idx.long()], epsilon)


def gaussian_weight_iterations(y: float, epsilon: float = 0.01) -> int:
    """Closed form of eq. (3) for the paper's eq. (12) weight family (§6.3):
    max(w) = 1/sqrt(2*pi), E(w) = exp(-y^2/4)/sqrt(4*pi)."""
    ratio = math.exp(-(y**2) / 4.0) / math.sqrt(2.0)
    return max(1, math.ceil(math.log(epsilon) / math.log(1.0 - ratio)))
