"""Megopolis resampling (paper Alg. 5), the reference algorithm, after
``repro.core.resamplers.megopolis``.

The ``B`` comparison offsets ``o[b] ~ U{0, N-1}`` are drawn once, globally,
and shared by every particle.  At iteration ``b`` particle ``i`` compares
its current ancestor ``k`` against

    j = (aligned(i) + aligned(o[b]) + (i + o[b]) mod S) mod N

with ``S`` the coalescing segment (32, the paper's warp, by default; the
CUDA kernels coalesce at 1024).  The draws are JAX's streams through the
threefry twin, so that ``megopolis(key, w, B)`` equals the JAX reference bit
for bit: offsets from ``split(key)[0]``, the uniforms of iteration ``b``
from ``fold_in(split(key)[1], b)``.  The accept test ``u·w[k] <= w[j]``
runs with subnormals flushed, as XLA on the CPU runs it.  Keys stay on the
CPU; the draws and the loop run on the weights' device.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import random as trandom
from repro_torch.core.resamplers.batched import split_batch_keys
from repro_torch.kernels.common import flush_to_zero, megopolis_indices

DEFAULT_SEGMENT = 32  # the paper's warp; the CUDA kernels coalesce at 1024.

__all__ = ["DEFAULT_SEGMENT", "megopolis", "megopolis_batch", "megopolis_indices"]


def megopolis(key: torch.Tensor, weights: torch.Tensor, num_iters: int, *,
              segment: int = DEFAULT_SEGMENT,
              offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Resample ``f32[N]`` weights; returns ancestors ``int32[N]`` (Alg. 5).
    ``offsets`` (``int[num_iters]``), when given, replace the offset draw;
    the uniforms are unchanged (the key splits the same way), the injection
    point of the shared-offset bank and of 'auto' (``core/spec.py``)."""
    n = weights.shape[0]
    num_iters = int(num_iters)
    key_off, key_u = trandom.split(key)
    if offsets is None:
        offsets = trandom.randint(key_off, (num_iters,), 0, n)
    offs = [int(o) for o in offsets[:num_iters].tolist()]
    w = flush_to_zero(weights.to(torch.float32))
    i = torch.arange(n, dtype=torch.int64, device=w.device)
    k = i
    for b in range(num_iters):
        j = megopolis_indices(i, offs[b], segment, n)
        u = trandom.uniform(trandom.fold_in(key_u, b), (n,), device=w.device)
        # u <= w[j] / w[k]  <=>  u * w[k] <= w[j]   (division-free, w >= 0)
        accept = flush_to_zero(u * w[k]) <= w[j]
        k = torch.where(accept, j, k)
    return k.to(torch.int32)


def megopolis_batch(key: torch.Tensor, weights: torch.Tensor, num_iters: int, *,
                    segment: int = DEFAULT_SEGMENT,
                    shared_offsets: bool = False) -> torch.Tensor:
    """Megopolis over ``weights[B, N]``.  ``shared_offsets=False``: row ``b``
    equals ``megopolis(split(key, B)[b], weights[b], ...)``.
    ``shared_offsets=True``: one offset table drawn from ``fold_in(key,
    num_iters)`` is shared by every row (Alg. 5's structure, the batched
    kernel's contract); row ``b`` then equals ``megopolis(split(key, B)[b],
    weights[b], ..., offsets=offsets)``."""
    if weights.ndim != 2:
        raise ValueError(
            f"megopolis_batch expects weights[B, N]; got shape {tuple(weights.shape)}")
    bsz, n = weights.shape
    keys = split_batch_keys(key, bsz)
    offsets = None
    if shared_offsets:
        offsets = trandom.randint(trandom.fold_in(key, num_iters), (int(num_iters),), 0, n)
    return torch.stack([megopolis(keys[b], weights[b], num_iters, segment=segment,
                                  offsets=offsets) for b in range(bsz)])
