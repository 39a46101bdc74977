"""Prefix-sum resamplers (the unbiased baselines of paper §6.5), the
reference algorithms, after ``repro.core.resamplers.prefix_sum``.

``multinomial`` is Alg. 7 (a binary search of each uniform over the
inclusive prefix sum), ``systematic`` and ``stratified`` the classical
searches, ``improved_systematic`` Alg. 8's bidirectional walk (on a
monotone prefix sum it is systematic's search clipped to N - 1, which is
how it is computed here; a NaN draw keeps its own index, as the walk
does), ``residual`` the deterministic ``floor(N w)`` copies plus a
multinomial rest.

Each follows the JAX reference op for op on the CPU:

* ``xla_cumsum`` adds in XLA-CPU's order for ``jnp.cumsum``, the plain
  scan's (rows of 16 scanned one add after the other, the rows' totals
  scanned the same way, zero padding at the end), not ``torch.cumsum``'s
  (ROADMAP Queue C items 14-15);
* ``searchsorted`` is ``jnp.searchsorted``'s default method, a bisection
  of ``ceil(log2(N + 1))`` steps under the sort order (NaN last, -0 = 0),
  so NaN and unsorted input follow JAX too;
* ``xla_sum`` (residual's normaliser) adds in windows of 32, as XLA-CPU's
  tree reduction rewrite does; it matches ``jnp.sum`` on most lengths but
  not all (``tests/test_torch_reference.py`` states the share);
* subnormals are flushed, as XLA on the CPU runs.
"""

from __future__ import annotations

import math

import torch

from repro_torch import random as trandom
from repro_torch.core.resamplers.batched import batch_via_vmap
from repro_torch.kernels.common import flush_to_zero
from repro_torch.kernels.prefix_sum.ref import sequential_scan, xla_scan

#: The window of XLA-CPU's tree reduction.
SUM_WINDOW = 32


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum`` along the last axis in XLA-CPU's order (the plain
    scan's, ``kernels.prefix_sum.ref.xla_scan``), subnormals flushed."""
    return xla_scan(flush_to_zero(x))


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``f32[N]`` in windows of 32, each added one after the
    other from zero, until 32 or fewer remain (XLA-CPU's tree reduction)."""
    v = flush_to_zero(x.reshape(-1))
    while v.shape[0] > SUM_WINDOW:
        rows = torch.nn.functional.pad(v, (0, -v.shape[0] % SUM_WINDOW))
        v = sequential_scan(rows.reshape(-1, SUM_WINDOW))[:, -1]
    return sequential_scan(torch.cat([v.new_zeros(1), v]))[-1]


def _sort_key(x: torch.Tensor) -> torch.Tensor:
    """Floats as int64 keys of JAX's sort order: -0 = 0, NaN last."""
    x = torch.where(x == 0, torch.zeros_like(x), x)
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    i = x.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(i < 0, -(i & 0x7FFFFFFF) - 1, i)


def searchsorted(sorted_arr: torch.Tensor, query: torch.Tensor, side: str) -> torch.Tensor:
    """``jnp.searchsorted(sorted_arr, query, side)`` (method 'scan') for a
    1-D ``sorted_arr``: ``int64`` indices in ``[0, N]``."""
    n = sorted_arr.shape[0]
    if sorted_arr.dtype.is_floating_point:
        a, q = _sort_key(sorted_arr), _sort_key(query)
    else:
        a, q = sorted_arr.to(torch.int64), query.to(torch.int64)
    low = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    high = torch.full_like(low, n)
    for _ in range(int(math.ceil(math.log2(n + 1)))):
        mid = (low + high) // 2
        am = a[mid.clamp(max=n - 1)]
        go_left = q <= am if side == "left" else q < am
        low, high = torch.where(go_left, low, mid), torch.where(go_left, mid, high)
    return high


def _scale(total: torch.Tensor, n: int) -> torch.Tensor:
    """``c[-1] / N``, a division, as the JAX reference runs it op by op."""
    return flush_to_zero(total / torch.tensor(float(n), dtype=torch.float32,
                                              device=total.device))


def multinomial(key, weights: torch.Tensor, num_iters: int = 0) -> torch.Tensor:
    """Paper Alg. 7.  ``num_iters`` ignored (API uniformity)."""
    del num_iters
    n = weights.shape[0]
    c = xla_cumsum(weights.to(torch.float32))
    u = flush_to_zero(trandom.uniform(key, (n,), device=c.device) * c[-1])
    return searchsorted(c, u, "right").to(torch.int32)


def _systematic_draws(key, c: torch.Tensor) -> torch.Tensor:
    n = c.shape[0]
    u0 = trandom.uniform(key, (), device=c.device)
    idx = torch.arange(n, dtype=torch.float32, device=c.device)
    return flush_to_zero(flush_to_zero(idx + u0) * _scale(c[-1], n))


def systematic(key, weights: torch.Tensor, num_iters: int = 0) -> torch.Tensor:
    """Systematic resampling via the search (the result of Alg. 8)."""
    del num_iters
    c = xla_cumsum(weights.to(torch.float32))
    return searchsorted(c, _systematic_draws(key, c), "left").to(torch.int32)


def improved_systematic(key, weights: torch.Tensor, num_iters: int = 0) -> torch.Tensor:
    """Paper Alg. 8: each lane ``i`` walks up from ``i`` while ``c < u``,
    then down while ``c >= u``.  On the monotone prefix sum of non-negative
    weights that ends at the first ``c >= u`` (N - 1 where none is); a NaN
    draw (a NaN or infinite total) stops both walks at once, so the lane
    keeps ``i``."""
    del num_iters
    n = weights.shape[0]
    c = xla_cumsum(weights.to(torch.float32))
    u = _systematic_draws(key, c)
    first = torch.searchsorted(c.contiguous(), u.contiguous(), side="left")
    i = torch.arange(n, dtype=torch.int64, device=c.device)
    return torch.where(torch.isnan(u), i, first.clamp(0, n - 1)).to(torch.int32)


def stratified(key, weights: torch.Tensor, num_iters: int = 0) -> torch.Tensor:
    """Stratified resampling: one uniform per stratum [i/N, (i+1)/N)."""
    del num_iters
    n = weights.shape[0]
    c = xla_cumsum(weights.to(torch.float32))
    idx = torch.arange(n, dtype=torch.float32, device=c.device)
    u = flush_to_zero(flush_to_zero(idx + trandom.uniform(key, (n,), device=c.device))
                      * _scale(c[-1], n))
    return searchsorted(c, u, "left").to(torch.int32)


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 as XLA converts: NaN to 0, out of range clamped."""
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    return x.clamp(-2.0**31, 2.0**31 - 128).to(torch.int32)


def residual(key, weights: torch.Tensor, num_iters: int = 0) -> torch.Tensor:
    """Residual resampling: deterministic ``floor(N w)`` copies plus a
    multinomial rest, by searches of the two prefix sums."""
    del num_iters
    n = weights.shape[0]
    w = flush_to_zero(weights.to(torch.float32))
    w = flush_to_zero(w / xla_sum(w))
    nw = flush_to_zero(w * float(n))
    counts = _to_int32(torch.floor(nw))
    n_det = counts.to(torch.int64).sum()
    resid = flush_to_zero(nw - counts.to(torch.float32))
    c = xla_cumsum(resid)
    cc = torch.cumsum(counts.to(torch.int64), dim=0).to(torch.int32)
    slots = torch.arange(n, dtype=torch.int32, device=w.device)
    det = searchsorted(cc, slots, "right")
    u = flush_to_zero(trandom.uniform(key, (n,), device=w.device) * c[-1])
    rnd = searchsorted(c, u, "right")
    return torch.where(slots.to(torch.int64) < n_det, det.clamp(max=n - 1),
                       rnd.clamp(max=n - 1)).to(torch.int32)


multinomial_batch = batch_via_vmap(multinomial)
systematic_batch = batch_via_vmap(systematic)
improved_systematic_batch = batch_via_vmap(improved_systematic)
stratified_batch = batch_via_vmap(stratified)
residual_batch = batch_via_vmap(residual)
