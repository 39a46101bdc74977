"""MCMC move kernels for the SMC sampler, after ``repro.ais.moves``
(DESIGN.md §10).

Each kernel rejuvenates N particles IN PARALLEL against a fixed
log-density (the current tempered target π_β): particles are independent
chains, so a sweep is one vectorised accept/reject.  Both return the mean
acceptance rate, which the sampler feeds back into a per-temperature
Robbins–Monro step-size adaptation (``adapt_step_size``)::

    x, accept = move(key, x, log_prob, step_size, num_steps)

``x`` is ``[N, d]`` with a key ``[2]`` and a scalar ``step_size``, or a
bank ``[S, N, d]`` with keys ``[S, 2]`` and ``step_size`` ``[S]``; row
``s`` of a bank is the single call on row ``s``'s key, particles and step
size.  The key chain is the JAX package's: ``split(key, num_steps)``, then
``split`` of each sweep's key into the proposal's and the accept draw's.
The acceptance rate of a sweep is the count of accepts over N (exact in
float32 up to 2^24 particles, so independent of the reduction's order),
and the rate returned the sweeps' sum, taken in order, over their number.
"""

from __future__ import annotations

import torch

from repro_torch import random as trandom

# Optimal-scaling acceptance targets (Roberts-Rosenthal asymptotics).
RWM_TARGET_ACCEPT = 0.234
MALA_TARGET_ACCEPT = 0.574


def _count(x: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` as a float32 tensor on ``x``'s device: dividing by it divides
    (a Python divisor is a multiply by its reciprocal on the card)."""
    return torch.tensor(float(n), dtype=torch.float32, device=x.device)


def _sweeps(key: torch.Tensor, num_steps: int):
    """Each sweep's (proposal key, accept key)."""
    keys = trandom.split(key, num_steps)
    for i in range(num_steps):
        pair = trandom.split(keys[..., i, :])
        yield pair[..., 0, :], pair[..., 1, :]


def _accept_rate(accept: torch.Tensor) -> torch.Tensor:
    n = accept.shape[-1]
    return accept.sum(dim=-1, dtype=torch.float32) / _count(accept, n)


def _per_particle(step_size, x: torch.Tensor) -> torch.Tensor:
    """The step size broadcast against ``x[..., N, d]``."""
    sz = torch.as_tensor(step_size, dtype=torch.float32).to(x.device)
    return sz.reshape(sz.shape + (1, 1))


def random_walk_metropolis(key, x, log_prob, step_size, num_steps: int):
    """``num_steps`` RWM sweeps over x; returns (x', mean_accept)."""
    sz = _per_particle(step_size, x)
    lp = log_prob(x)
    total = None
    for k_prop, k_acc in _sweeps(key, num_steps):
        prop = x + sz * trandom.normal(k_prop, x.shape[-2:], device=x.device)
        lp_prop = log_prob(prop)
        log_u = torch.log(trandom.uniform(k_acc, lp.shape[-1:], device=x.device))
        accept = log_u < lp_prop - lp
        x = torch.where(accept.unsqueeze(-1), prop, x)
        lp = torch.where(accept, lp_prop, lp)
        rate = _accept_rate(accept)
        total = rate if total is None else total + rate
    return x, total / _count(total, num_steps)


def _value_and_grad(log_prob, y: torch.Tensor):
    """``(log_prob(y), ∇ Σ log_prob(y))``: particles are independent, so the
    gradient of the sum is each particle's gradient (one reverse pass for
    the whole bank).  The graph lives only inside this call."""
    with torch.enable_grad():
        y = y.detach().requires_grad_(True)
        lp = log_prob(y)
        (g,) = torch.autograd.grad(lp.sum(), y)
    return lp.detach(), g


def mala(key, x, log_prob, step_size, num_steps: int):
    """Metropolis-adjusted Langevin: gradient-informed proposal and exact MH
    correction; returns (x', mean_accept)."""
    sz = _per_particle(step_size, x)
    half_sq = 0.5 * torch.square(sz)

    def log_q(to, frm, g_frm):
        # log N(to; frm + (ε²/2)·∇logπ(frm), ε²·I), per particle
        mean = frm + half_sq * g_frm
        return -0.5 * torch.square((to - mean) / sz).sum(dim=-1)

    lp, g = _value_and_grad(log_prob, x)
    total = None
    for k_prop, k_acc in _sweeps(key, num_steps):
        noise = trandom.normal(k_prop, x.shape[-2:], device=x.device)
        prop = x + half_sq * g + sz * noise
        lp_prop, g_prop = _value_and_grad(log_prob, prop)
        log_alpha = lp_prop - lp + log_q(x, prop, g_prop) - log_q(prop, x, g)
        log_u = torch.log(trandom.uniform(k_acc, lp.shape[-1:], device=x.device))
        accept = log_u < log_alpha
        x = torch.where(accept.unsqueeze(-1), prop, x)
        lp = torch.where(accept, lp_prop, lp)
        g = torch.where(accept.unsqueeze(-1), g_prop, g)
        rate = _accept_rate(accept)
        total = rate if total is None else total + rate
    return x, total / _count(total, num_steps)


MOVES = {"rwm": random_walk_metropolis, "mala": mala}
TARGET_ACCEPT = {"rwm": RWM_TARGET_ACCEPT, "mala": MALA_TARGET_ACCEPT}


def adapt_step_size(step_size, accept, target_accept, rate: float = 0.5,
                    lo: float = 1e-4, hi: float = 1e3):
    """Robbins–Monro-style log-scale update toward the target acceptance:
    ε ← ε·exp(rate·(accept − target)), clipped to [lo, hi]."""
    return torch.clamp(step_size * torch.exp(rate * (accept - target_accept)), lo, hi)
