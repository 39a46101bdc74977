"""Weight-sequence generators of the paper's experimental regime (§5),
after ``repro.core.weightgen``.

Method 1 (Murray et al., paper eq. 12): Gaussian-likelihood weights
``w = exp(-(x - y)^2 / 2) / sqrt(2*pi)`` with ``x ~ N(0,1)``; increasing
``y`` concentrates weight on few particles (simulated degeneracy).  ``x``
comes from ``repro_torch.random.normal``, within 3 ULP of
``jax.random.normal``, so the weights agree with JAX's to a few ULP, not
bit for bit.

Method 2 (Dülger et al., paper eq. 13): Gamma(alpha, beta=1) samples; not
ported yet.
"""

from __future__ import annotations

import math

import torch

from repro_torch import random as trandom
from repro_torch import resolve_device

GAUSSIAN_Y_GRID = (0.0, 1.0, 2.0, 3.0, 4.0)
GAMMA_ALPHA_GRID = (0.5, 2.0, 3.0, 10.0, 50.0)


def gaussian_weights(key: torch.Tensor, n: int, y: float, device="cuda") -> torch.Tensor:
    """Eq. (12) weights ``f32[N]`` on ``device`` (the device rule of
    ``repro_torch``: ``cuda`` needs a card)."""
    x = trandom.normal(key, (n,), device=resolve_device(device))
    scale = torch.sqrt(torch.tensor(2.0 * math.pi, dtype=torch.float32, device=x.device))
    return torch.exp(-0.5 * (x - y) ** 2) / scale


def gamma_weights(key, n: int, alpha: float, beta: float = 1.0, device="cuda"):
    """Eq. (13) weights: not ported yet."""
    resolve_device(device)
    raise NotImplementedError(
        "gamma_weights needs a twin of jax.random.gamma, which is not ported yet "
        "(ROADMAP Queue A, item 12: the gamma sampler)"
    )
