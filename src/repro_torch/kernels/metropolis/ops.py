"""Public wrappers of the Metropolis-family kernels: key in, ancestors or
resampled state out (after ``repro.kernels.metropolis.ops``).  Alg. 2 first;
the C1/C2 variants (Algs. 3-4, ``c1c2_tables``) at the end of the module.

Alg. 2 needs no offset table: each call derives only the hash seed, so a
step does less host work than Megopolis's (one ``key_to_seed`` against
``split``, ``randint`` and ``key_to_seed``).  The seeds follow the JAX
wrappers:

* ``key_to_seed(key)`` for the single entries;
* ``key_to_seed(split(key, S))`` for ``batch``/``apply_batch`` (the
  split-key contract of ``core.resamplers.batched.split_batch_keys``: row
  ``s`` equals the single call with ``split(key, S)[s]``);
* ``key_to_seed(keys)`` for the explicit per-row-key forms.

Particles are ``[N]`` or ``[N, ...]`` (``[S, N, ...]`` for the bank forms),
and ``N % 1024 == 0``.
"""

from __future__ import annotations

from repro_torch import random as trandom
from repro_torch.kernels.common import SEG, from_planes, key_to_seed, to_planes
from repro_torch.kernels.metropolis.c1c2 import (
    metropolis_c1,
    metropolis_c1_batch,
    metropolis_c1_fused,
    metropolis_c1_fused_batch,
    metropolis_c1_step,
    metropolis_c1_step_rows,
    metropolis_c2,
    metropolis_c2_batch,
    metropolis_c2_fused,
    metropolis_c2_fused_batch,
    metropolis_c2_step,
    metropolis_c2_step_rows,
    table_width,
)
from repro_torch.kernels.metropolis.metropolis import (
    metropolis,
    metropolis_batch,
    metropolis_fused,
    metropolis_fused_batch,
    metropolis_step,
    metropolis_step_rows,
)


def metropolis_cuda(key, weights, num_iters: int):
    """Index-only resample of one population: ancestors ``int32[N]``."""
    return metropolis(weights, key_to_seed(key), num_iters)


def metropolis_cuda_batch(key, weights, num_iters: int):
    """Index-only resample of a bank under one key, in one launch; row
    ``s`` equals ``metropolis_cuda(split(key, S)[s], weights[s])``."""
    return metropolis_batch(weights, key_to_seed(trandom.split(key, weights.shape[0])),
                            num_iters)


def metropolis_cuda_batch_rows(keys, weights, num_iters: int):
    """Index-only resample over explicit per-row keys ``[S, 2]``: row ``s``
    equals ``metropolis_cuda(keys[s], weights[s])``, in one launch."""
    return metropolis_batch(weights, key_to_seed(keys), num_iters)


def metropolis_cuda_apply(key, weights, particles, num_iters: int):
    """Fused resample + gather of one population; returns
    ``(particles', ancestors int32[N])``."""
    anc, out = metropolis_fused(weights, to_planes(particles, 1), key_to_seed(key), num_iters)
    return from_planes(out, particles), anc


def _apply_bank(seeds, weights, particles, num_iters):
    anc, out = metropolis_fused_batch(weights, to_planes(particles, 2), seeds, num_iters)
    return from_planes(out, particles), anc


def metropolis_cuda_apply_batch(key, weights, particles, num_iters: int):
    """Bank form under one key (split-key contract), in one launch."""
    seeds = key_to_seed(trandom.split(key, weights.shape[0]))
    return _apply_bank(seeds, weights, particles, num_iters)


def metropolis_cuda_apply_rows(keys, weights, particles, num_iters: int):
    """Bank form over explicit per-row keys ``[S, 2]``, in one launch."""
    return _apply_bank(key_to_seed(keys), weights, particles, num_iters)


def metropolis_cuda_step(key, log_weights, particles, num_iters: int, ess_threshold: float):
    """Fused SMC step of one population from UNNORMALISED log-weights:
    returns ``(particles', ancestors, stats f32[4])``."""
    anc, out, stats = metropolis_step(log_weights, to_planes(particles, 1), key_to_seed(key),
                                      num_iters, ess_threshold)
    return from_planes(out, particles), anc, stats


def metropolis_cuda_step_rows(keys, log_weights, particles, num_iters: int,
                              ess_threshold: float):
    """Bank form of the step over per-row keys: each row takes its own
    decision; returns ``(particles', ancestors int32[S, N], stats f32[S, 4])``."""
    anc, out, stats = metropolis_step_rows(log_weights, to_planes(particles, 2),
                                           key_to_seed(keys), num_iters, ess_threshold)
    return from_planes(out, particles), anc, stats



# -------------------------------------------------- Metropolis-C1/C2 (Algs. 3-4)


def c1c2_tables(variant: int, keys, n: int, num_iters: int, device):
    """``(partitions int32[..., T or T·B], seeds int64[...])`` of one key or
    a key bank ``[S, 2]``, as ``metropolis_c{1,2}_tpu`` derive them: ``kp,
    kloop = split(key)``, the table ``randint(kp, (T,), 0, T)`` for C1 or
    ``randint(kp, (T·B,), 0, T)`` for C2 (row-major by tile), the seed
    ``key_to_seed(kloop)``.  C2's table is as large as the work (23 M
    entries for a bank of 64 rows at N = 2**20, B = 354), so its draws are
    made on ``device`` (the weights'), the key chain staying where the keys
    lie: the same integer arithmetic, the same bits."""
    halves = trandom.split(keys)
    size = table_width(variant, n, num_iters)
    partitions = trandom.randint(halves[..., 0, :], (size,), 0, n // SEG, device=device)
    return partitions, key_to_seed(halves[..., 1, :])


def _c1c2_index(fn, variant, keys, weights, num_iters):
    parts, seeds = c1c2_tables(variant, keys, weights.shape[-1], num_iters, weights.device)
    return fn(weights, parts, seeds, num_iters)


def _c1c2_apply(fn, variant, keys, weights, particles, num_iters):
    parts, seeds = c1c2_tables(variant, keys, weights.shape[-1], num_iters, weights.device)
    anc, out = fn(weights, to_planes(particles, weights.ndim), parts, seeds, num_iters)
    return from_planes(out, particles), anc


def _c1c2_step(fn, variant, keys, log_weights, particles, num_iters, ess_threshold):
    parts, seeds = c1c2_tables(variant, keys, log_weights.shape[-1], num_iters,
                               log_weights.device)
    anc, out, stats = fn(log_weights, to_planes(particles, log_weights.ndim), parts, seeds,
                         num_iters, ess_threshold)
    return from_planes(out, particles), anc, stats


def metropolis_c1_cuda(key, weights, num_iters: int):
    """Index-only C1 resample of one population: ancestors ``int32[N]``."""
    return _c1c2_index(metropolis_c1, 1, key, weights, num_iters)


def metropolis_c2_cuda(key, weights, num_iters: int):
    """Index-only C2 resample of one population: ancestors ``int32[N]``."""
    return _c1c2_index(metropolis_c2, 2, key, weights, num_iters)


def metropolis_c1_cuda_batch(key, weights, num_iters: int):
    """C1 over a bank under one key, in one launch; row ``s`` equals
    ``metropolis_c1_cuda(split(key, S)[s], weights[s])``."""
    keys = trandom.split(key, weights.shape[0])
    return _c1c2_index(metropolis_c1_batch, 1, keys, weights, num_iters)


def metropolis_c2_cuda_batch(key, weights, num_iters: int):
    """C2 over a bank under one key (split-key contract), in one launch."""
    keys = trandom.split(key, weights.shape[0])
    return _c1c2_index(metropolis_c2_batch, 2, keys, weights, num_iters)


def metropolis_c1_cuda_batch_rows(keys, weights, num_iters: int):
    """C1 over explicit per-row keys ``[S, 2]``, in one launch."""
    return _c1c2_index(metropolis_c1_batch, 1, keys, weights, num_iters)


def metropolis_c2_cuda_batch_rows(keys, weights, num_iters: int):
    """C2 over explicit per-row keys ``[S, 2]``, in one launch."""
    return _c1c2_index(metropolis_c2_batch, 2, keys, weights, num_iters)


def metropolis_c1_cuda_apply(key, weights, particles, num_iters: int):
    """Fused C1 resample + gather of one population; returns
    ``(particles', ancestors int32[N])``."""
    return _c1c2_apply(metropolis_c1_fused, 1, key, weights, particles, num_iters)


def metropolis_c2_cuda_apply(key, weights, particles, num_iters: int):
    """Fused C2 resample + gather of one population."""
    return _c1c2_apply(metropolis_c2_fused, 2, key, weights, particles, num_iters)


def metropolis_c1_cuda_apply_batch(key, weights, particles, num_iters: int):
    """Bank form of the C1 apply under one key (split-key contract)."""
    keys = trandom.split(key, weights.shape[0])
    return _c1c2_apply(metropolis_c1_fused_batch, 1, keys, weights, particles, num_iters)


def metropolis_c2_cuda_apply_batch(key, weights, particles, num_iters: int):
    """Bank form of the C2 apply under one key (split-key contract)."""
    keys = trandom.split(key, weights.shape[0])
    return _c1c2_apply(metropolis_c2_fused_batch, 2, keys, weights, particles, num_iters)


def metropolis_c1_cuda_apply_rows(keys, weights, particles, num_iters: int):
    """Bank form of the C1 apply over explicit per-row keys."""
    return _c1c2_apply(metropolis_c1_fused_batch, 1, keys, weights, particles, num_iters)


def metropolis_c2_cuda_apply_rows(keys, weights, particles, num_iters: int):
    """Bank form of the C2 apply over explicit per-row keys."""
    return _c1c2_apply(metropolis_c2_fused_batch, 2, keys, weights, particles, num_iters)


def metropolis_c1_cuda_step(key, log_weights, particles, num_iters: int, ess_threshold: float):
    """Fused SMC step with C1 from UNNORMALISED log-weights: returns
    ``(particles', ancestors, stats f32[4])``."""
    return _c1c2_step(metropolis_c1_step, 1, key, log_weights, particles, num_iters,
                      ess_threshold)


def metropolis_c2_cuda_step(key, log_weights, particles, num_iters: int, ess_threshold: float):
    """Fused SMC step with C2 from UNNORMALISED log-weights."""
    return _c1c2_step(metropolis_c2_step, 2, key, log_weights, particles, num_iters,
                      ess_threshold)


def metropolis_c1_cuda_step_rows(keys, log_weights, particles, num_iters: int,
                                 ess_threshold: float):
    """Bank form of the C1 step over per-row keys, each row with its own
    decision."""
    return _c1c2_step(metropolis_c1_step_rows, 1, keys, log_weights, particles, num_iters,
                      ess_threshold)


def metropolis_c2_cuda_step_rows(keys, log_weights, particles, num_iters: int,
                                 ess_threshold: float):
    """Bank form of the C2 step over per-row keys."""
    return _c1c2_step(metropolis_c2_step_rows, 2, keys, log_weights, particles, num_iters,
                      ess_threshold)
