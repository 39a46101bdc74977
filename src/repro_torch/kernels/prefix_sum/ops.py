"""Public wrappers of the prefix-sum kernels: key in, ancestors or resampled
state out (after ``repro.kernels.prefix_sum.ops``).

The five kinds compose the family's two stages, the block scan and the
bisection, as the JAX wrappers do:

* ``multinomial`` (Alg. 7): ``uniform(key, (N,))·total``, ``right``;
* ``systematic`` and ``improved_systematic`` (Alg. 8): ``(i +
  uniform(key, ()))·(total / N)``, ``left``; improved systematic equals
  systematic's search form, so it runs the same kernels on the same draws;
* ``stratified``: ``(i + uniform(key, (N,)))·(total / N)``, ``left``;
* ``residual``: three scans (the weights' total, the counts ``floor(N·w)``,
  the residuals ``N·w - counts``), then slot ``i < n_det`` bisects the count
  CDF at ``i`` and every other slot the residual CDF at
  ``uniform(key, (N,))·total``; N <= 2**24 (``ValueError`` above).

The uniforms are drawn outside the kernels with ``repro_torch.random``: the
scalar ``u0`` on the host beside the key, ``(N,)`` draws on the weights'
device.  Keys: ``key`` for the single entries, ``split(key, S)`` for
``batch``/``apply_batch`` (row ``s`` is the single call with ``split(key,
S)[s]``), ``keys[s]`` for the per-row forms.  Each stage is one launch
over the bank, of the bank wrappers (one population is a bank of one row):
index only, a scan and a search (residual: three scans and two searches);
``apply``, a scan and a search with the state copy (residual: three scans
and the select); ``step``, one launch.  Particles
are ``[N]`` or ``[N, ...]`` (``[S, N, ...]`` for the bank forms).

Compressed planes (DESIGN.md §14): weights, log-weights and particles may
come in a 2-byte plane dtype (the spec narrows them).  Only the first scan's
input travels compressed; the draws are float32 (``repro_torch.random``
draws nothing else), and the host's arithmetic on the weights, residual's
``w / total``, runs on them upcast to float32, as the JAX package's runs on
its float32 quantised weights.
"""

from __future__ import annotations

import torch

from repro_torch import random as trandom
from repro_torch.core.resamplers.batched import split_batch_keys
from repro_torch.kernels.common import flush_to_zero, from_planes, to_planes
from repro_torch.kernels.prefix_sum.prefix_sum import prefix_sum_rows
from repro_torch.kernels.prefix_sum.ref import (  # noqa: F401  (PREFIX_KINDS re-exported)
    KIND_CODES,
    PREFIX_KINDS,
    draws_rise,
    residual_parts,
    scaled_draws,
    side_is_right,
)
from repro_torch.kernels.prefix_sum.search import (
    residual_select_gather_rows,
    searchsorted_gather_rows,
    searchsorted_rows,
)
from repro_torch.kernels.prefix_sum.step import check_kind, prefix_step_rows


def prefix_sum_cuda(x: torch.Tensor) -> torch.Tensor:
    """The raw 1-D inclusive scan (``prefix_sum_tpu``)."""
    return prefix_sum_rows(x.unsqueeze(0))[0]


def searchsorted_cuda(cdf: torch.Tensor, u: torch.Tensor, side: str = "left") -> torch.Tensor:
    """The raw 1-D bisection (``searchsorted_tpu``)."""
    return searchsorted_rows(cdf.unsqueeze(0), u.unsqueeze(0), side)[0]


def draw_bases(keys: torch.Tensor, n: int, kind: str, device):
    """The key-derived halves of the draws of a bank with keys ``[S, 2]``:
    ``(ubase f32[S, N], None)`` drawn on ``device``, or for the systematic
    kinds ``(None, u0 f32[S])`` drawn beside the keys."""
    if KIND_CODES[kind] == 1:
        return None, trandom.uniform(keys, ())
    return trandom.uniform(keys, (n,), device=device), None


def kind_draws(keys: torch.Tensor, n: int, total: torch.Tensor, kind: str):
    """The search values of each row and the side: ``(u f32[S, N],
    "left"/"right")`` from the CDF totals ``total [S]``, by the JAX
    package's formulas (``kind_draws``)."""
    ubase, u0 = draw_bases(keys, n, kind, total.device)
    u0 = None if u0 is None else u0.to(total.device)
    return scaled_draws(kind, total, n, ubase, u0), "right" if side_is_right(kind) else "left"


def _residual_scans(keys, w):
    """Residual's three scans and its draws: ``(cc, c, u, n_det)``."""
    n = w.shape[-1]
    total = prefix_sum_rows(w)[:, -1]
    counts, resid, n_det = residual_parts(flush_to_zero(w.to(torch.float32)), total)
    cc, c = prefix_sum_rows(counts), prefix_sum_rows(resid)
    u = scaled_draws("residual", c[:, -1], n, draw_bases(keys, n, "residual", w.device)[0])
    return cc, c, u, n_det


def _residual_cuda(keys, w):
    """Residual on the kernels, index only: three scans, then the two
    searches and the slot select (the launches of ``ops._residual_tpu``)."""
    s, n = w.shape
    cc, c, u, n_det = _residual_scans(keys, w)
    slots = torch.arange(n, device=w.device)
    det = searchsorted_rows(cc, slots.to(torch.float32).expand(s, n).contiguous(), "right", True)
    rnd = searchsorted_rows(c, u, "right", False)
    return torch.where(slots < n_det.unsqueeze(-1), det, rnd)


def _residual_cuda_fused(keys, w, state):
    """Residual on the kernels with the state copy: three scans, then one
    launch of the select (``ops._residual_tpu_fused``)."""
    cc, c, u, n_det = _residual_scans(keys, w)
    return residual_select_gather_rows(cc, c, u, n_det, state)


def _resample(keys, w, kind, state=None):
    """One entry's launches over ``w [S, N]`` with per-row keys ``[S, 2]``:
    ancestors ``int32[S, N]``, or with ``state [S, D, N]`` ``(ancestors,
    state')``."""
    check_kind("prefix_resample_cuda", kind, w.shape[-1])
    if kind == "residual":
        if state is None:
            return _residual_cuda(keys, w)
        return _residual_cuda_fused(keys, w, state)
    c = prefix_sum_rows(w)
    u, side = kind_draws(keys, w.shape[-1], c[:, -1], kind)
    if state is None:
        return searchsorted_rows(c, u, side, draws_rise(kind))
    return searchsorted_gather_rows(c, u, state, side, draws_rise(kind))


def prefix_resample_cuda(key, weights, kind: str = "systematic"):
    """Index-only resample of one population: ancestors ``int32[N]``."""
    return _resample(key[None], weights[None], kind)[0]


def prefix_resample_cuda_batch(key, weights, kind: str = "systematic"):
    """Index-only resample of a bank under one key; row ``s`` equals
    ``prefix_resample_cuda(split(key, S)[s], weights[s])``."""
    return _resample(split_batch_keys(key, weights.shape[0]), weights, kind)


def prefix_resample_cuda_batch_rows(keys, weights, kind: str = "systematic"):
    """Index-only resample over explicit per-row keys ``[S, 2]``."""
    return _resample(keys, weights, kind)


def prefix_resample_cuda_apply(key, weights, particles, kind: str = "systematic"):
    """Fused resample + gather of one population; returns ``(particles',
    ancestors int32[N])``."""
    anc, out = _resample(key[None], weights[None], kind, to_planes(particles, 1)[None])
    return from_planes(out[0], particles), anc[0]


def _apply_bank(keys, weights, particles, kind):
    anc, out = _resample(keys, weights, kind, to_planes(particles, 2))
    return from_planes(out, particles), anc


def prefix_resample_cuda_apply_batch(key, weights, particles, kind: str = "systematic"):
    """Bank form under one key (split-key contract)."""
    return _apply_bank(split_batch_keys(key, weights.shape[0]), weights, particles, kind)


def prefix_resample_cuda_apply_rows(keys, weights, particles, kind: str = "systematic"):
    """Bank form over explicit per-row keys ``[S, 2]``."""
    return _apply_bank(keys, weights, particles, kind)


def prefix_resample_cuda_step(key, log_weights, particles, ess_threshold: float,
                              kind: str = "systematic"):
    """Fused SMC step of one population from UNNORMALISED log-weights, in
    one launch: ``(particles', ancestors, stats f32[4])``."""
    check_kind("prefix_resample_cuda_step", kind, log_weights.shape[-1])
    ubase, u0 = draw_bases(key[None], log_weights.shape[-1], kind, log_weights.device)
    anc, out, stats = prefix_step_rows(log_weights[None], to_planes(particles, 1)[None], ubase,
                                       u0, ess_threshold, kind)
    return from_planes(out[0], particles), anc[0], stats[0]


def prefix_resample_cuda_step_rows(keys, log_weights, particles, ess_threshold: float,
                                   kind: str = "systematic"):
    """Bank form of the step over per-row keys, each row with its own
    decision: ``(particles', ancestors int32[S, N], stats f32[S, 4])``."""
    check_kind("prefix_resample_cuda_step_rows", kind, log_weights.shape[-1])
    ubase, u0 = draw_bases(keys, log_weights.shape[-1], kind, log_weights.device)
    anc, out, stats = prefix_step_rows(log_weights, to_planes(particles, 2), ubase, u0,
                                       ess_threshold, kind)
    return from_planes(out, particles), anc, stats
