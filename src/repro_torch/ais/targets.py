"""Annealing targets with analytic logZ ground truth, after
``repro.ais.targets`` (DESIGN.md §10).

An adaptive-SMC sampler anneals from a NORMALISED base density π0 to an
UNNORMALISED target γ along the geometric path

    log π_β(x) = (1 − β) · log π0(x) + β · log γ(x),      β: 0 → 1,

and its output logZ estimates log ∫ γ(x) dx.  Each family carries that
integral in closed form where one exists (``Target.log_z``, a Python float
computed with numpy as in the JAX package), so resampler quality is scored
against ground truth.

The callables broadcast over leading scenario axes: ``log_base(x[..., N,
d]) -> f32[..., N]``, ``log_target(x[..., N, d]) -> f32[..., N]``,
``sample_base(key, n) -> f32[n, d]`` (a key bank ``[S, 2]`` draws ``[S, n,
d]``, row ``s`` from ``key[s]``).  Theta families take a trailing ``theta``
dict whose leaves are ``[d]`` / ``[]`` for one scenario and ``[S, 1, d]`` /
``[S, 1]`` for a bank (``run_smc_sampler_bank`` lays them out so).

Device rule: each constructor takes ``device="cuda"`` (raising without a
card unless ``device="cpu"``) and keeps its constants there; the draws of
``sample_base`` land on it.  Keys stay threefry key data on the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Target:
    """One annealing problem: normalised base π0, unnormalised target γ.

    ``log_z`` is the analytic log ∫ γ when known (None otherwise, e.g. the
    logistic-regression posterior); ``log_z_fn(theta)`` is the per-scenario
    form for theta families.  ``device`` is where the constants live and
    the draws land.
    """

    dim: int
    log_base: Callable  # (x[..., N, d][, theta]) -> f32[..., N]   normalised log π0
    sample_base: Callable  # (key, n[, theta]) -> f32[n, d]
    log_target: Callable  # (x[..., N, d][, theta]) -> f32[..., N]  unnormalised log γ
    log_z: Optional[float] = None
    log_z_fn: Optional[Callable] = None  # (theta) -> f32  for theta families
    name: str = "target"
    device: torch.device = torch.device("cpu")


def _f32(value: float, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def _normal_base(dim: int, scale: float, device: torch.device):
    """Normalised N(0, scale²·I_dim) base: (log_base, sample_base)."""
    log_norm = float(-0.5 * dim * np.log(2.0 * np.pi * scale**2))

    def log_base(x):
        return log_norm - 0.5 * torch.square(x / scale).sum(dim=-1)

    def sample_base(key, n):
        return scale * trandom.normal(key, (n, dim), device=device)

    return log_base, sample_base


def isotropic_gaussian(dim: int = 2, mean: float = 1.0, sigma: float = 1.0,
                       base_scale: float = 3.0, device="cuda") -> Target:
    """γ(x) = exp(−‖x − μ‖² / 2σ²); logZ = (d/2)·log(2πσ²) exactly."""
    dev = resolve_device(device)
    mu = torch.full((dim,), mean, dtype=torch.float32, device=dev)
    log_base, sample_base = _normal_base(dim, base_scale, dev)

    def log_target(x):
        return -0.5 * torch.square((x - mu) / sigma).sum(dim=-1)

    return Target(
        dim=dim, log_base=log_base, sample_base=sample_base, log_target=log_target,
        log_z=float(0.5 * dim * np.log(2.0 * np.pi * sigma**2)),
        name="isotropic_gaussian", device=dev,
    )


def correlated_gaussian(dim: int = 4, rho: float = 0.7, base_scale: float = 3.0,
                        device="cuda") -> Target:
    """γ(x) = exp(−½ xᵀ Σ⁻¹ x), Σ_ij = ρ^|i−j|; logZ = ½·log det(2πΣ)."""
    dev = resolve_device(device)
    idx = np.arange(dim)
    cov = rho ** np.abs(idx[:, None] - idx[None, :])
    prec = torch.as_tensor(np.linalg.inv(cov), dtype=torch.float32).to(dev)
    sign, logdet = np.linalg.slogdet(2.0 * np.pi * cov)
    assert sign > 0
    log_base, sample_base = _normal_base(dim, base_scale, dev)

    def log_target(x):
        return -0.5 * ((x @ prec) * x).sum(dim=-1)

    return Target(
        dim=dim, log_base=log_base, sample_base=sample_base, log_target=log_target,
        log_z=float(0.5 * logdet), name="correlated_gaussian", device=dev,
    )


def gaussian_mixture(means=((-2.0, -2.0), (2.0, 2.0)), sigma: float = 1.0,
                     mass: float = 2.5, base_scale: float = 4.0, device="cuda") -> Target:
    """γ(x) = mass · Σ_k (1/K)·N(x; μ_k, σ²I): components normalised and
    equally weighted, so logZ = log(mass) exactly regardless of geometry."""
    dev = resolve_device(device)
    mus = torch.as_tensor(means, dtype=torch.float32).to(dev)  # [K, d]
    k_comp, dim = mus.shape
    log_norm = float(-0.5 * dim * np.log(2.0 * np.pi * sigma**2))
    log_weight = torch.log(_f32(mass / k_comp, dev))
    log_base, sample_base = _normal_base(dim, base_scale, dev)

    def log_target(x):
        # [..., N, K] component log-densities -> logsumexp over components
        d2 = torch.square(x.unsqueeze(-2) - mus).sum(dim=-1)
        comp = log_norm - 0.5 * d2 / sigma**2
        return torch.logsumexp(comp, dim=-1) + log_weight

    return Target(
        dim=dim, log_base=log_base, sample_base=sample_base, log_target=log_target,
        log_z=float(np.log(mass)), name="gaussian_mixture", device=dev,
    )


def banana(bend: float = 0.1, sigma1: float = 2.0, base_scale: float = 4.0,
           device="cuda") -> Target:
    """The 2-d banana: a unit-Jacobian shear of a product Gaussian.

    γ(x) = exp(−x₁²/2σ₁² − ½·(x₂ + b·x₁² − b·σ₁²)²).  The shear
    x₂ ↦ x₂ + b·x₁² − b·σ₁² preserves volume, so logZ = log(2π·σ₁)
    exactly even though the density is strongly non-Gaussian.
    """
    dev = resolve_device(device)
    log_base, sample_base = _normal_base(2, base_scale, dev)

    def log_target(x):
        x1, x2 = x[..., 0], x[..., 1]
        y2 = x2 + bend * torch.square(x1) - bend * sigma1**2
        return -0.5 * torch.square(x1 / sigma1) - 0.5 * torch.square(y2)

    return Target(
        dim=2, log_base=log_base, sample_base=sample_base, log_target=log_target,
        log_z=float(np.log(2.0 * np.pi * sigma1)), name="banana", device=dev,
    )


def logistic_regression(key=None, num_data: int = 64, dim: int = 4,
                        base_scale: float = 2.0, device="cuda") -> Target:
    """Bayesian logistic regression on synthetic data: γ(θ) = N(θ; 0, I) ·
    Π_i σ(y_i·x_iᵀθ).  No analytic logZ (``log_z=None``).  The data come
    from ``key`` (default ``PRNGKey(7)``) split in three, drawn on the CPU
    with the threefry twins, then moved to ``device``."""
    dev = resolve_device(device)
    key = trandom.PRNGKey(7) if key is None else key
    kx, kw, ky = trandom.split(key, 3)
    x_data = trandom.normal(kx, (num_data, dim))
    w_true = trandom.normal(kw, (dim,))
    logits = x_data @ w_true
    y = torch.where(trandom.uniform(ky, (num_data,)) < torch.sigmoid(logits), 1.0, -1.0)
    x_data, y = x_data.to(dev), y.to(dev)
    prior_norm = -0.5 * dim * torch.log(_f32(2.0 * math.pi, dev))
    log_base, sample_base = _normal_base(dim, base_scale, dev)

    def log_target(theta):
        # prior N(0, I) + Bernoulli likelihood
        prior = prior_norm - 0.5 * torch.square(theta).sum(dim=-1)
        margins = (theta @ x_data.T) * y  # [..., N, num_data]
        return prior + torch.nn.functional.logsigmoid(margins).sum(dim=-1)

    return Target(
        dim=dim, log_base=log_base, sample_base=sample_base, log_target=log_target,
        log_z=None, name="logistic_regression", device=dev,
    )


# ------------------------------------------------------------ theta families

def gaussian_family(dim: int = 2, base_scale: float = 3.0, device="cuda") -> Target:
    """A theta-family of isotropic Gaussians for the §4 scenario axis.

    ``theta = {'mean': f32[d], 'sigma': f32[]}`` selects the scenario
    (``gaussian_theta``); ``run_smc_sampler_bank`` takes the leaves stacked
    along a leading [S] axis.  logZ per scenario via ``log_z_fn(theta)``.
    """
    dev = resolve_device(device)
    log_base, sample_base = _normal_base(dim, base_scale, dev)
    two_pi = _f32(2.0 * math.pi, dev)

    def log_target(x, theta):
        sigma = theta["sigma"].unsqueeze(-1)
        return -0.5 * torch.square((x - theta["mean"]) / sigma).sum(dim=-1)

    def log_z_fn(theta):
        return 0.5 * dim * torch.log(two_pi * torch.square(theta["sigma"]))

    return Target(
        dim=dim,
        log_base=lambda x, theta: log_base(x),
        sample_base=lambda key, n, theta: sample_base(key, n),
        log_target=log_target, log_z_fn=log_z_fn, name="gaussian_family", device=dev,
    )


def gaussian_theta(mean, sigma: float = 1.0, dim: int = 2, device="cuda") -> dict:
    """One scenario of ``gaussian_family`` (stack leaves for a bank)."""
    dev = resolve_device(device)
    return {
        "mean": torch.full((dim,), float(mean), dtype=torch.float32, device=dev),
        "sigma": torch.tensor(float(sigma), dtype=torch.float32, device=dev),
    }
