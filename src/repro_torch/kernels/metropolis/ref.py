"""Plain PyTorch versions of the Metropolis-family CUDA kernels, on the
same signatures (after ``repro.kernels.metropolis.ref``: ``metropolis_ref``,
``metropolis_c1_ref``, ``metropolis_c2_ref``).

They repeat the kernels' arithmetic without any kernel machinery: the
accept test ``u·w[k] <= w[j]`` with ``u = hash_uniform(seed, i + N, b)``;
``w[k]`` carried by value; the flushes of ``kernels/common.py``.  The
proposal differs by algorithm:

* Alg. 2 (Metropolis): ``j = hash_bits(seed, i, b) mod N``, a uniform index
  over the whole row;
* Algs. 3-4 (Metropolis-C1/C2): ``j = p·1024 + (hash_bits(seed, i, b) mod
  1024)``, a random lane of one partition tile ``p``, where ``p =
  partitions[s, i // 1024]`` for C1 (one tile kept for all B iterations) and
  ``p = partitions[s, (i // 1024)·B + b]`` for C2 (a fresh tile each
  iteration).

The launch wrappers run them for CPU tensors, the CPU tests hold them
against the JAX package's Pallas kernels in interpret mode, and
``chip_smoke.py`` holds the CUDA kernels against them on the card.

Shapes: a bank of S rows of N particles, state ``[S, D, N]``, seeds
``int64[S]`` holding uint32 values, partition tables ``int32[S, T]`` (C1)
or ``int32[S, T·B]`` (C2) with T = N / 1024.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.common import (
    MASK32,
    SEG,
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


def partition_tiles(partitions: torch.Tensor, n: int, num_iters: int, variant: int, b: int):
    """The partition tile of every particle at iteration ``b``, ``int64[S,
    N]``: ``partitions[s, i // 1024]`` for C1, ``partitions[s, (i // 1024)·B
    + b]`` for C2."""
    tile = torch.arange(n, device=partitions.device) // SEG
    col = tile if variant == 1 else tile * num_iters + b
    return partitions.to(torch.int64)[:, col]


def _sweep_c1c2(w: torch.Tensor, partitions: torch.Tensor, seeds: torch.Tensor,
                num_iters: int, variant: int) -> torch.Tensor:
    """The Algs. 3-4 sweep over ``w[S, N]``: ancestors ``int64[S, N]``."""
    n = w.shape[-1]
    w = flush_to_zero(w.to(torch.float32))
    partitions = partitions.to(w.device)
    i = tile_lane_ids(n, w.device).to(torch.int64).unsqueeze(0)
    seeds = seeds.to(device=w.device, dtype=torch.int64).unsqueeze(-1)
    k = i.expand_as(w)
    wk = w
    for b in range(num_iters):
        if b == 0 or variant == 2:
            base = partition_tiles(partitions, n, num_iters, variant, b) * SEG
        j = base + (hash_bits(seeds, i, b) & (SEG - 1))  # Algs. 3-4: p·N_w + U{0, N_w - 1}
        w_j = torch.gather(w, 1, j)
        u = accept_uniform(seeds, i, n, b)
        accept = flush_to_zero(u * wk) <= w_j  # u <= w[j] / w[k]
        k = torch.where(accept, j, k)
        wk = torch.where(accept, w_j, wk)
    return k


def metropolis_c1c2_rows_ref(w: torch.Tensor, state: Optional[torch.Tensor],
                             partitions: torch.Tensor, seeds: torch.Tensor, num_iters: int,
                             variant: int):
    """Plain version of ``metropolis_c1c2_rows_kernel<variant>``: ancestors
    ``int32[S, N]`` when ``state`` is None (index only), else ``(ancestors,
    state' [S, D, N])``."""
    k = _sweep_c1c2(w, partitions, seeds, num_iters, variant)
    if state is None:
        return k.to(torch.int32)
    return k.to(torch.int32), gather_state(state, k)


def metropolis_c1c2_step_rows_ref(lw: torch.Tensor, state: torch.Tensor,
                                  partitions: torch.Tensor, seeds: torch.Tensor,
                                  num_iters: int, thr: float, variant: int):
    """Plain version of ``metropolis_c1c2_step_rows_kernel<variant>``:
    ``step_stats`` per row, the trigger ``ess_norm < thr``, the sweep on
    ``exp(lw - m)`` (uniform ``1/N`` on a degenerate row), then the selection
    or the identity.  Returns ``(ancestors int32[S, N], state' [S, D, N],
    stats f32[S, 4])``."""
    w, do, stats = step_weights(lw, thr)
    k = step_select(do, _sweep_c1c2(w, partitions, seeds, num_iters, variant))
    return k.to(torch.int32), gather_state(state, k), stats
