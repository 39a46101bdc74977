"""Metropolis resampling and its C1/C2 variants (paper Algs. 2-4), the
reference algorithms, after ``repro.core.resamplers.metropolis``.

``metropolis`` draws a fresh comparison index per (particle, iteration),
the random access of Fig. 2.  C1/C2 (Dülger et al.) draw it from a
warp-shared random partition of ``partition_size_bytes`` of weights (Fig.
3): C1 one partition per warp for all iterations, C2 a fresh one every
iteration.  Any partition size and warp is valid here (the CUDA kernels
take one tile of 4096 bytes).  Every draw is JAX's stream through the
threefry twin, so each call equals the JAX reference bit for bit; the
accept test runs with subnormals flushed, as XLA on the CPU runs it.
"""

from __future__ import annotations

import torch

from repro_torch import random as trandom
from repro_torch.core.resamplers.batched import batch_via_vmap
from repro_torch.kernels.common import flush_to_zero

WARP = 32  # threads per warp in the paper's cost model.


def _sweep(key_of, weights: torch.Tensor, num_iters: int, proposal) -> torch.Tensor:
    """The accept/reject loop: at iteration ``b`` the keys ``key_of(b) ->
    (kj, ku)`` draw the proposals ``proposal(kj)`` and the uniforms."""
    n = weights.shape[0]
    w = flush_to_zero(weights.to(torch.float32))
    k = torch.arange(n, dtype=torch.int64, device=w.device)
    for b in range(int(num_iters)):
        kj, ku = key_of(b)
        j = proposal(kj)
        u = trandom.uniform(ku, (n,), device=w.device)
        accept = flush_to_zero(u * w[k]) <= w[j]
        k = torch.where(accept, j, k)
    return k.to(torch.int32)


def metropolis(key: torch.Tensor, weights: torch.Tensor, num_iters: int) -> torch.Tensor:
    """Paper Alg. 2; returns ancestors ``int32[N]``."""
    n = weights.shape[0]

    def key_of(b):
        kj, ku = trandom.split(trandom.fold_in(key, b))
        return kj, ku

    return _sweep(key_of, weights, num_iters,
                  lambda kj: trandom.randint(kj, (n,), 0, n, device=weights.device).long())


metropolis_batch = batch_via_vmap(metropolis)


def _partition_geometry(n: int, partition_size_bytes: int, dtype_bytes: int = 4):
    """The paper's N_part / N_w (Algs. 3-4 lines 1-2)."""
    n_w = max(1, partition_size_bytes // dtype_bytes)
    n_part = max(1, (n * dtype_bytes) // partition_size_bytes)
    return n_part, n_w


def _partitions(kp, n: int, n_part: int, warp: int, device) -> torch.Tensor:
    """Each particle's partition: one draw ``U{0, N_part - 1}`` per warp."""
    p_warp = trandom.randint(kp, ((n + warp - 1) // warp,), 0, n_part, device=device).long()
    return p_warp[torch.arange(n, device=device) // warp]


def _in_partition(p: torch.Tensor, kj, n_w: int) -> torch.Tensor:
    """``j = p·N_w + U{0, N_w - 1}``, clipped to the ragged tail."""
    n = p.shape[0]
    j = p * n_w + trandom.randint(kj, (n,), 0, n_w, device=p.device).long()
    return torch.clamp(j, max=n - 1)


def metropolis_c1(key: torch.Tensor, weights: torch.Tensor, num_iters: int, *,
                  partition_size_bytes: int = 128, warp: int = WARP) -> torch.Tensor:
    """Paper Alg. 3: one shared partition per warp for ALL iterations."""
    n = weights.shape[0]
    n_part, n_w = _partition_geometry(n, partition_size_bytes)
    kp, kloop = trandom.split(key)
    p = _partitions(kp, n, n_part, warp, weights.device)

    def key_of(b):
        kj, ku = trandom.split(trandom.fold_in(kloop, b))
        return kj, ku

    return _sweep(key_of, weights, num_iters, lambda kj: _in_partition(p, kj, n_w))


def metropolis_c2(key: torch.Tensor, weights: torch.Tensor, num_iters: int, *,
                  partition_size_bytes: int = 128, warp: int = WARP) -> torch.Tensor:
    """Paper Alg. 4: a fresh warp-shared partition EVERY iteration."""
    n = weights.shape[0]
    n_part, n_w = _partition_geometry(n, partition_size_bytes)

    def key_of(b):
        kp, kj, ku = trandom.split(trandom.fold_in(key, b), 3)
        return (kp, kj), ku

    return _sweep(key_of, weights, num_iters, lambda kpj: _in_partition(
        _partitions(kpj[0], n, n_part, warp, weights.device), kpj[1], n_w))


metropolis_c1_batch = batch_via_vmap(metropolis_c1)
metropolis_c2_batch = batch_via_vmap(metropolis_c2)
