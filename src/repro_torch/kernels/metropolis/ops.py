"""Public wrappers of the Metropolis kernels: key in, ancestors or resampled
state out (after ``repro.kernels.metropolis.ops``).

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
from repro_torch.kernels.common import from_planes, key_to_seed, to_planes
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
