"""Tempering schedules: fixed geometric and adaptive CESS bisection, after
``repro.ais.schedule`` (DESIGN.md §10).

* ``geometric_schedule``: β log-spaced between ``beta_min`` and 1, ending
  at exactly 1.0.
* ``next_temperature``: the LARGEST Δβ whose incremental weights keep the
  conditional ESS at a target fraction of N, found by bisection.

The conditional ESS (``conditional_ess``) is measured against the CURRENT
normalised weights, so it equals N at Δβ = 0 however degenerate the
accumulated weights are, and the bisection always finds a strictly
positive step.

The JAX package bisects inside a ``lax.while_loop`` that stops when the
bracket is narrower than ``tol`` or after ``max_iters`` rounds; under
``vmap`` a converged row holds its bracket while the others go on.  Here
every call runs all ``max_iters`` rounds, and a row whose bracket is
already narrower than ``tol`` holds it: the bracket a row ends with is the
one JAX's loop stops at, and the loop never waits on the card.  Both
``next_temperature`` and ``conditional_ess`` take one row ``[N]`` or a
bank ``[S, N]`` (``beta_prev`` then ``[S]``).
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device


def geometric_schedule(num_temps: int, beta_min: float = 1e-2, device="cuda") -> torch.Tensor:
    """β_t = beta_min^(1 − t/T) for t = 1..T: log-spaced, ends exactly at 1.

    The ``pow`` is float32 on ``device``; it may round a value otherwise
    than XLA's (the endpoint is set, not computed)."""
    if num_temps < 1:
        raise ValueError(f"geometric_schedule: num_temps must be >= 1; got {num_temps}")
    if not 0.0 < beta_min < 1.0:
        raise ValueError(f"geometric_schedule: beta_min must be in (0, 1); got {beta_min}")
    dev = resolve_device(device)
    t = torch.arange(1, num_temps + 1, dtype=torch.float32, device=dev) / num_temps
    betas = torch.pow(torch.tensor(beta_min, dtype=torch.float32, device=dev), 1.0 - t)
    betas[-1] = 1.0  # exact endpoint, no float pow residue
    return betas


def _cess(log_norm_w: torch.Tensor, log_u: torch.Tensor) -> torch.Tensor:
    """``N·(Σ W·u)² / Σ W·u²`` from the normalised log-weights."""
    n = log_norm_w.shape[-1]
    a = torch.logsumexp(log_norm_w + log_u, dim=-1)  # log Σ W u
    b = torch.logsumexp(log_norm_w + 2.0 * log_u, dim=-1)  # log Σ W u²
    return n * torch.exp(2.0 * a - b)


def _normalised(log_w: torch.Tensor) -> torch.Tensor:
    return log_w - torch.logsumexp(log_w, dim=-1, keepdim=True)


def conditional_ess(log_w: torch.Tensor, log_u: torch.Tensor) -> torch.Tensor:
    """CESS = N·(Σ W·u)² / Σ W·u²  with W the normalised current weights.

    ``log_w`` are the accumulated log-weights, ``log_u`` the candidate
    incremental log-weights.  Equals N when u is constant (Δβ = 0).
    """
    return _cess(_normalised(log_w), log_u)


def next_temperature(log_w: torch.Tensor, delta: torch.Tensor, beta_prev, target_cess: float,
                     *, tol: float = 1e-6, max_iters: int = 60) -> torch.Tensor:
    """Largest β ∈ (beta_prev, 1] keeping CESS/N at ``target_cess``.

    ``delta[..., i] = log γ(x_i) − log π0(x_i)`` is the geometric-path
    tilt, so the incremental log-weight of a step to β is
    (β − beta_prev)·delta.  CESS/N is 1 at β = beta_prev and (generically)
    decreasing in β, so the bracket [beta_prev, 1] contains the crossing;
    if even the full jump to 1 keeps CESS above target, returns exactly
    1.0.  The returned β is the lower bracket end: realised CESS/N ≥ target
    up to the bisection ``tol``.  Returns ``f32[]`` (``f32[S]`` for a
    bank)."""
    n = log_w.shape[-1]
    beta_prev = torch.as_tensor(beta_prev, dtype=torch.float32).to(log_w.device)
    beta_prev = beta_prev.expand(log_w.shape[:-1])
    log_norm_w = _normalised(log_w)
    count = torch.tensor(float(n), dtype=torch.float32, device=log_w.device)

    def cess_frac(beta):
        return _cess(log_norm_w, (beta - beta_prev).unsqueeze(-1) * delta) / count

    lo = beta_prev
    hi = torch.ones_like(beta_prev)
    for _ in range(max_iters):
        live = (hi - lo) > tol
        mid = 0.5 * (lo + hi)
        ok = cess_frac(mid) >= target_cess
        lo, hi = torch.where(live & ok, mid, lo), torch.where(live & ~ok, mid, hi)
    full_ok = cess_frac(hi.new_ones(())) >= target_cess
    return torch.where(full_ok, torch.ones_like(lo), lo)
