"""Plain PyTorch versions of the Metropolis CUDA kernels, on the same
signatures (after ``repro.kernels.metropolis.ref.metropolis_ref``).

They repeat the kernels' arithmetic without any kernel machinery: the
proposal ``j = hash_bits(seed, i, b) mod N``, a uniform index over the whole
row; the accept test ``u·w[k] <= w[j]`` with ``u = hash_uniform(seed, i + N,
b)``; ``w[k]`` carried by value; the flushes of ``kernels/common.py``.  The
launch wrappers run them for CPU tensors, the CPU tests hold them against
the JAX package's Pallas kernels in interpret mode, and ``chip_smoke.py``
holds the CUDA kernels against them on the card.

Shapes: a bank of S rows of N particles, state ``[S, D, N]``, seeds
``int64[S]`` holding uint32 values.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.common import (
    MASK32,
    flush_to_zero,
    gather_state,
    hash_bits,
    hash_uniform,
    step_select,
    step_weights,
    tile_lane_ids,
)


def proposal_index(seeds, i, n: int, b: int):
    """Alg. 2's proposal of lane ``i`` at iteration ``b``: ``hash_bits(seed,
    i, b) mod N``, unsigned, as ``int64``."""
    return hash_bits(seeds, i, b) % n


def accept_uniform(seeds, i, n: int, b: int) -> torch.Tensor:
    """The accept test's uniform of lane ``i`` at iteration ``b``: the hash
    stream at lane ``(uint32)(i + N)``, masked as the kernels' 32-bit sum."""
    return hash_uniform(seeds, (i + n) & MASK32, b)


def _sweep(w: torch.Tensor, seeds: torch.Tensor, num_iters: int) -> torch.Tensor:
    """The Alg. 2 sweep over ``w[S, N]``: ancestors ``int64[S, N]``."""
    n = w.shape[-1]
    w = flush_to_zero(w.to(torch.float32))
    i = tile_lane_ids(n, w.device).to(torch.int64).unsqueeze(0)
    seeds = seeds.to(device=w.device, dtype=torch.int64).unsqueeze(-1)
    k = i.expand_as(w)
    wk = w
    for b in range(num_iters):
        j = proposal_index(seeds, i, n, b)
        w_j = torch.gather(w, 1, j)
        u = accept_uniform(seeds, i, n, b)
        accept = flush_to_zero(u * wk) <= w_j  # u <= w[j] / w[k]
        k = torch.where(accept, j, k)
        wk = torch.where(accept, w_j, wk)
    return k


def metropolis_rows_ref(w: torch.Tensor, state: Optional[torch.Tensor], seeds: torch.Tensor,
                        num_iters: int):
    """Plain version of ``metropolis_rows_kernel``: ancestors ``int32[S, N]``
    when ``state`` is None (index only), else ``(ancestors, state' [S, D,
    N])``."""
    k = _sweep(w, seeds, num_iters)
    if state is None:
        return k.to(torch.int32)
    return k.to(torch.int32), gather_state(state, k)


def metropolis_step_rows_ref(lw: torch.Tensor, state: torch.Tensor, seeds: torch.Tensor,
                             num_iters: int, thr: float):
    """Plain version of ``metropolis_step_rows_kernel``: ``step_stats`` per
    row, the trigger ``ess_norm < thr``, the sweep on ``exp(lw - m)``
    (uniform ``1/N`` on a degenerate row), then the selection or the
    identity.  Returns ``(ancestors int32[S, N], state' [S, D, N], stats
    f32[S, 4])``."""
    w, do, stats = step_weights(lw, thr)
    k = step_select(do, _sweep(w, seeds, num_iters))
    return k.to(torch.int32), gather_state(state, k), stats
