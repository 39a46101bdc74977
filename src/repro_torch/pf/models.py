"""Benchmark state-space models, after ``repro.pf.models``.

``ungm`` is the univariate nonlinear growth model of the paper's §7
(eqs. 22-23):

    x_t = x_{t-1}/2 + 25 x_{t-1} / (1 + x_{t-1}^2) + 8 cos(1.2 t) + v,
    z_t = x_t^2 / 20 + n,            v ~ N(0, 10),  n ~ N(0, 1).

The noise comes from the threefry ``normal`` twin (within 3 ULP of
``jax.random.normal``), drawn on the particles' device.  A key bank
``[S, 2]`` with particles ``[S, N]`` draws row ``s`` from ``key[s]``.  The
likelihood's output is flushed to zero, as XLA flushes it on the CPU
(``exp(-r²/2)`` is subnormal for residuals beyond about 13.2).
"""

from __future__ import annotations

import math

import torch

from repro_torch import random as trandom
from repro_torch import resolve_device
from repro_torch.kernels.common import flush_to_zero
from repro_torch.pf.filter import StateSpaceModel

_SIGMA_V2 = 10.0  # process-noise variance (paper: sigma_v^2 = 10)
_SIGMA_N2 = 1.0  # measurement-noise variance (paper: sigma_n^2 = 1)


def _noise(key: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Standard normal noise shaped like ``x``, one key per leading row."""
    return trandom.normal(key, x.shape[key.dim() - 1 :], device=x.device)


def _drift(x, t):
    return x / 2.0 + 25.0 * x / (1.0 + x * x)


def _transition(key, x, t):
    v = _noise(key, x) * math.sqrt(_SIGMA_V2)
    return _drift(x, t) + 8.0 * torch.cos(1.2 * t) + v


def _observe(key, x, t):
    n = _noise(key, x) * math.sqrt(_SIGMA_N2)
    return x * x / 20.0 + n


def _likelihood(z, x, t):
    resid = z - x * x / 20.0
    return flush_to_zero(torch.exp(-0.5 * (resid * resid) / _SIGMA_N2))


def _init(key, n, device="cuda"):
    """``n`` particles from N(0, 10) (``[S, n]`` for a key bank)."""
    dev = resolve_device(device)
    return trandom.normal(key, (n,), device=dev) * math.sqrt(_SIGMA_V2)


def ungm() -> StateSpaceModel:
    return StateSpaceModel(
        transition=_transition,
        observe=_observe,
        likelihood=_likelihood,
        init=_init,
        name="ungm",
    )


# ---------------------------------------------------------------- scenarios
def ungm_theta(amp: float = 8.0, obs_var: float = _SIGMA_N2) -> dict:
    """One scenario's parameters for ``ungm_family``: forcing amplitude and
    measurement-noise variance (float32 scalars on the CPU)."""
    return {"amp": torch.tensor(amp, dtype=torch.float32),
            "obs_var": torch.tensor(obs_var, dtype=torch.float32)}


def _transition_theta(key, x, t, theta):
    v = _noise(key, x) * math.sqrt(_SIGMA_V2)
    return _drift(x, t) + theta["amp"] * torch.cos(1.2 * t) + v


def _observe_theta(key, x, t, theta):
    n = _noise(key, x) * torch.sqrt(theta["obs_var"])
    return x * x / 20.0 + n


def _likelihood_theta(z, x, t, theta):
    resid = z - x * x / 20.0
    return flush_to_zero(torch.exp(-0.5 * (resid * resid) / theta["obs_var"]))


def ungm_family() -> StateSpaceModel:
    """UNGM with per-scenario parameters (a trailing ``theta`` dict): the
    scenario-axis model for ``run_filter_bank``.  ``theta == ungm_theta()``
    reproduces ``ungm``."""
    return StateSpaceModel(
        transition=_transition_theta,
        observe=_observe_theta,
        likelihood=_likelihood_theta,
        init=_init,
        name="ungm-family",
    )
