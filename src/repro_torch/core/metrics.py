"""Weight and ancestor diagnostics and the resampling-quality metrics of
paper §5 (offspring counts, eqs. 14-21), after ``repro.core.metrics``.

Every helper reduces over ``axis`` (default the last) and accepts banks
``[..., N]``.  Sums run in torch's order, which is not XLA's.
"""

from __future__ import annotations

import torch


def _tiny_floor(dtype) -> float:
    """Smallest safe positive floor: 1e-30, or the dtype's min normal."""
    return max(float(torch.finfo(dtype).tiny), 1e-30)


def _guarded_shift(log_w: torch.Tensor, axis: int) -> torch.Tensor:
    """Shift-by-max, guarded against a non-finite max (then 0)."""
    m = log_w.amax(dim=axis, keepdim=True)
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def degenerate_log_weights(log_w: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """True where a row carries no usable information: all ``-inf``, any
    ``nan`` or any ``+inf`` (the max is not finite)."""
    return ~torch.isfinite(log_w.amax(dim=axis))


def normalise_log_weights(log_w: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``exp(log_w - max(log_w))``; degenerate rows come back uniform
    ``1/N``."""
    n = log_w.shape[axis]
    deg = degenerate_log_weights(log_w, axis=axis).unsqueeze(axis)
    w = torch.exp(log_w - _guarded_shift(log_w, axis))
    return torch.where(deg, torch.full_like(w, 1.0 / n), w)


def degenerate_weights(w: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Linear-weight twin: a row is degenerate when its total mass is not a
    positive finite number."""
    s = w.sum(dim=axis)
    return ~(torch.isfinite(s) & (s > 0))


def log_weights_from_linear(w: torch.Tensor) -> torch.Tensor:
    """Log-weights from linear weights, floored at the dtype's normal
    range."""
    return torch.log(torch.clamp(w, min=_tiny_floor(w.dtype)))


def effective_sample_size(log_w: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """ESS = (Σw)² / Σw² from log-weights, shift-by-max stabilised."""
    w = normalise_log_weights(log_w, axis=axis)
    s1 = w.sum(dim=axis)
    s2 = (w * w).sum(dim=axis)
    return (s1 * s1) / torch.clamp(s2, min=_tiny_floor(s2.dtype))


def log_mean_weight(log_w: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``log(mean(exp(log_w)))`` as ``m + log(Σ exp(log_w - m)) - log(N)``."""
    m = _guarded_shift(log_w, axis)
    s1 = torch.exp(log_w - m).sum(dim=axis)
    n = torch.tensor(float(log_w.shape[axis]), dtype=torch.float32, device=log_w.device)
    return (m.squeeze(axis) + torch.log(s1)) - torch.log(n)


def max_normalised_weight(log_w: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Largest normalised weight ``max(w) / Σw``."""
    w = normalise_log_weights(log_w, axis=axis)
    s1 = w.sum(dim=axis)
    return w.amax(dim=axis) / torch.clamp(s1, min=_tiny_floor(s1.dtype))


def unique_ancestor_count(ancestors: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Number of distinct ancestors per row, sort based (no scatter), as
    int32; identity ancestors count N, a collapsed row counts 1."""
    s = torch.sort(ancestors.movedim(axis, -1), dim=-1).values
    breaks = (s[..., 1:] != s[..., :-1]).to(torch.int32)
    return (1 + breaks.sum(dim=-1)).to(torch.int32)


def offspring_counts(ancestors: torch.Tensor, n: int) -> torch.Tensor:
    """``o[..., i] = #{j : ancestors[..., j] == i}`` over the last axis, for
    one ancestor vector ``[N]`` or a matrix ``[K, N]`` (one ``bincount`` of
    length ``n`` exactly per row)."""
    flat = ancestors.reshape(-1, ancestors.shape[-1]).to(torch.int64)
    rows = torch.arange(flat.shape[0], device=flat.device).unsqueeze(-1) * n
    counts = torch.bincount((flat + rows).reshape(-1), minlength=flat.shape[0] * n)
    return counts.reshape(ancestors.shape[:-1] + (n,)).to(torch.int32)


def expected_offspring(weights: torch.Tensor) -> torch.Tensor:
    """``N·w_i / Σw`` (the target of eq. 14)."""
    n = weights.shape[0]
    return n * weights / weights.sum()


def squared_error(offspring: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """SE(o_k), eq. (14)."""
    return ((offspring - expected_offspring(weights)) ** 2).sum()


def mse(offsprings: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """MSE over K runs, eq. (15); ``offsprings`` is ``int[K, N]``."""
    target = expected_offspring(weights)
    return ((offsprings - target) ** 2).sum(dim=-1).mean()


def bias_variance(offsprings: torch.Tensor, weights: torch.Tensor):
    """The decomposition of eqs. (16)-(20): ``(var, bias_sq, mse)`` over K
    Monte Carlo runs ``int[K, N]`` of one weight vector.  K = 1 carries no
    variance information: the deviations are identically zero, and the
    k - 1 denominator is taken as 1, so var = 0 (as in JAX)."""
    k = offsprings.shape[0]
    target = expected_offspring(weights)
    o_hat = offsprings.to(torch.float32).mean(dim=0)  # eq. 19
    var = (((offsprings - o_hat) ** 2).sum(dim=0) / max(k - 1, 1)).sum()
    bias_sq = ((o_hat - target) ** 2).sum()  # eq. 18
    return var, bias_sq, var + bias_sq  # eq. 16


def bias_contribution(offsprings: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``||Bias||^2 / MSE``, eq. (21)."""
    _, bias_sq, total = bias_variance(offsprings, weights)
    return bias_sq / torch.clamp(total, min=1e-30)
