"""Plain PyTorch versions of the Megopolis CUDA kernels, on the same
signatures (after ``repro.kernels.megopolis.ref``).

They repeat the kernels' arithmetic (the same hash RNG, the same segment-1024
index map, the same value-carried ``w[k]``, the same flushes) without any
kernel machinery.  The launch wrappers run them for CPU tensors, the CPU
tests hold them against the JAX package's Pallas kernels in interpret mode,
and ``chip_smoke.py`` holds the CUDA kernels against them on the card.

Shapes: a bank of S rows of N particles, state ``[S, D, N]``, offset tables
``int32[S, B]``, seeds ``int64[S]`` holding uint32 values.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import (
    SEG,
    flush_to_zero,
    gather_state,
    hash_uniform,
    megopolis_indices,
    step_select,
    step_weights,
    tile_lane_ids,
)


def _sweep(w: torch.Tensor, offsets: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """The Alg. 5 sweep over ``w[S, N]``: ancestors ``int64[S, N]``."""
    n = w.shape[-1]
    w = flush_to_zero(w.to(torch.float32))
    i = tile_lane_ids(n, w.device).to(torch.int64).unsqueeze(0)
    seeds = seeds.to(device=w.device, dtype=torch.int64).unsqueeze(-1)
    offsets = offsets.to(device=w.device, dtype=torch.int64)
    k = i.expand_as(w)
    wk = w
    for b in range(offsets.shape[-1]):
        j = megopolis_indices(i, offsets[:, b : b + 1], SEG, n)
        w_j = torch.gather(w, 1, j)
        u = hash_uniform(seeds, i, b)
        accept = flush_to_zero(u * wk) <= w_j  # u <= w[j] / w[k]  (Alg. 5 line 13)
        k = torch.where(accept, j, k)
        wk = torch.where(accept, w_j, wk)
    return k


def megopolis_rows_ref(w: torch.Tensor, offsets: torch.Tensor,
                       seeds: torch.Tensor) -> torch.Tensor:
    """Plain version of the index-only ``megopolis_rows``: ancestors
    ``int32[S, N]``."""
    return _sweep(w, offsets, seeds).to(torch.int32)


def megopolis_fused_rows_ref(w: torch.Tensor, state: torch.Tensor,
                             offsets: torch.Tensor, seeds: torch.Tensor):
    """Plain version of ``megopolis_fused_rows``: returns
    ``(ancestors int32[S, N], state' [S, D, N])``."""
    k = _sweep(w, offsets, seeds)
    return k.to(torch.int32), gather_state(state, k)


def megopolis_step_rows_ref(lw: torch.Tensor, state: torch.Tensor,
                            offsets: torch.Tensor, seeds: torch.Tensor, thr: float):
    """Plain version of ``megopolis_step_rows``: ``step_stats`` per row, the
    trigger ``ess_norm < thr``, the sweep on ``exp(lw - m)`` (uniform ``1/N``
    on a degenerate row), then the selection or the identity.  Returns
    ``(ancestors int32[S, N], state' [S, D, N], stats f32[S, 4])`` with
    ``stats = (ess_norm, incr if resampled else 0, resampled, max_weight)``."""
    w, do, stats = step_weights(lw, thr)
    k = step_select(do, _sweep(w, offsets, seeds))
    return k.to(torch.int32), gather_state(state, k), stats
