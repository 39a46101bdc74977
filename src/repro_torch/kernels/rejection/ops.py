"""Public wrappers of the rejection kernels: key in, ancestors or resampled
state out (after ``repro.kernels.rejection.ops``).

Each call derives only the hash seed, as the JAX wrappers do:

* ``key_to_seed(key)`` for the single entries;
* ``key_to_seed(split(key, S))`` for ``batch``/``apply_batch`` (the
  split-key contract of ``core.resamplers.batched.split_batch_keys``: row
  ``s`` equals the single call with ``split(key, S)[s]``);
* ``key_to_seed(keys)`` for the explicit per-row-key forms (the JAX
  package's ``batch_rows`` maps the single call over the rows).

Every bank form is one launch.  Particles are ``[N]`` or ``[N, ...]``
(``[S, N, ...]`` for the bank forms), and ``N % 1024 == 0``.
"""

from __future__ import annotations

from repro_torch import random as trandom
from repro_torch.kernels.common import from_planes, key_to_seed, to_planes
from repro_torch.kernels.rejection.rejection import (
    rejection,
    rejection_batch,
    rejection_fused,
    rejection_fused_batch,
    rejection_step,
    rejection_step_rows,
)


def rejection_cuda(key, weights, max_iters: int):
    """Index-only resample of one population: ancestors ``int32[N]``."""
    return rejection(weights, key_to_seed(key), max_iters)


def rejection_cuda_batch(key, weights, max_iters: int):
    """Index-only resample of a bank under one key, in one launch; row
    ``s`` equals ``rejection_cuda(split(key, S)[s], weights[s])``."""
    return rejection_batch(weights, key_to_seed(trandom.split(key, weights.shape[0])),
                           max_iters)


def rejection_cuda_batch_rows(keys, weights, max_iters: int):
    """Index-only resample over explicit per-row keys ``[S, 2]``: row ``s``
    equals ``rejection_cuda(keys[s], weights[s])``, in one launch."""
    return rejection_batch(weights, key_to_seed(keys), max_iters)


def rejection_cuda_apply(key, weights, particles, max_iters: int):
    """Fused resample + gather of one population; returns
    ``(particles', ancestors int32[N])``."""
    anc, out = rejection_fused(weights, to_planes(particles, 1), key_to_seed(key), max_iters)
    return from_planes(out, particles), anc


def _apply_bank(seeds, weights, particles, max_iters):
    anc, out = rejection_fused_batch(weights, to_planes(particles, 2), seeds, max_iters)
    return from_planes(out, particles), anc


def rejection_cuda_apply_batch(key, weights, particles, max_iters: int):
    """Bank form under one key (split-key contract), in one launch."""
    seeds = key_to_seed(trandom.split(key, weights.shape[0]))
    return _apply_bank(seeds, weights, particles, max_iters)


def rejection_cuda_apply_rows(keys, weights, particles, max_iters: int):
    """Bank form over explicit per-row keys ``[S, 2]``, in one launch."""
    return _apply_bank(key_to_seed(keys), weights, particles, max_iters)


def rejection_cuda_step(key, log_weights, particles, max_iters: int, ess_threshold: float):
    """Fused SMC step of one population from UNNORMALISED log-weights:
    returns ``(particles', ancestors, stats f32[4])``."""
    anc, out, stats = rejection_step(log_weights, to_planes(particles, 1), key_to_seed(key),
                                     max_iters, ess_threshold)
    return from_planes(out, particles), anc, stats


def rejection_cuda_step_rows(keys, log_weights, particles, max_iters: int,
                             ess_threshold: float):
    """Bank form of the step over per-row keys: each row takes its own
    decision; returns ``(particles', ancestors int32[S, N], stats f32[S, 4])``."""
    anc, out, stats = rejection_step_rows(log_weights, to_planes(particles, 2),
                                          key_to_seed(keys), max_iters, ess_threshold)
    return from_planes(out, particles), anc, stats
