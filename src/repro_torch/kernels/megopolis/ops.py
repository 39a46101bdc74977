"""Public wrappers of the Megopolis kernels: key in, ancestors or resampled
state out (after ``repro.kernels.megopolis.ops``).

They derive the offsets and the hash seed from the key exactly as the JAX
wrappers do (``split``, then ``randint(key_off, (B,), 0, N)``, then
``key_to_seed``), so that the same key gives the same ancestors on both
sides.  Key derivation runs where the key lies (the CPU, for the key chains
the filter threads); the tables then go to the weights' device.

Particles are ``[N]`` or ``[N, ...]`` (``[S, N, ...]`` for the bank forms);
inside, the state is ``[D, N]`` (``[S, D, N]``).  Alignment: ``N % 1024 ==
0``, as on the TPU.
"""

from __future__ import annotations

from repro_torch import random as trandom
from repro_torch.kernels.common import from_planes, key_to_seed, to_planes
from repro_torch.kernels.megopolis.megopolis import (
    megopolis,
    megopolis_batch,
    megopolis_fused,
    megopolis_fused_rows,
    megopolis_rows,
    megopolis_step,
    megopolis_step_rows,
)


def key_tables(key, n: int, num_iters: int):
    """``(offsets int32[..., B], seed int64[...])`` of one key or a key bank,
    as ``megopolis_tpu``/``megopolis_tpu_apply``/``_rows`` derive them."""
    halves = trandom.split(key)
    offsets = trandom.randint(halves[..., 0, :], (num_iters,), 0, n)
    return offsets, key_to_seed(halves[..., 1, :])


def batch_tables(key, rows: int, n: int, num_iters: int):
    """``(offsets int32[B], seeds int64[S])`` of a bank under one key: ONE
    offset table shared by every row and a seed per row from
    ``split(key_rows, S)``, as ``megopolis_tpu_batch`` derives them."""
    halves = trandom.split(key)
    offsets = trandom.randint(halves[0], (num_iters,), 0, n)
    return offsets, key_to_seed(trandom.split(halves[1], rows))


def megopolis_cuda(key, weights, num_iters: int):
    """Index-only resample of one population: ancestors ``int32[N]``."""
    offsets, seed = key_tables(key, weights.shape[0], num_iters)
    return megopolis(weights, offsets, seed)


def megopolis_cuda_batch(key, weights, num_iters: int):
    """Index-only resample of a bank under one key, in one launch: one
    offset table shared by every row, so row ``s`` is NOT the single call
    with ``split(key, S)[s]`` (the JAX kernel path's own contract)."""
    offsets, seeds = batch_tables(key, weights.shape[0], weights.shape[1], num_iters)
    return megopolis_batch(weights, offsets, seeds)


def megopolis_cuda_batch_rows(keys, weights, num_iters: int):
    """Index-only resample of a bank over explicit per-row keys ``[S, 2]``:
    row ``s`` equals ``megopolis_cuda(keys[s], weights[s])``, in one
    launch."""
    offsets, seeds = key_tables(keys, weights.shape[1], num_iters)
    return megopolis_rows(weights, offsets, seeds)


def megopolis_cuda_apply(key, weights, particles, num_iters: int):
    """Fused resample + gather of one population; returns
    ``(particles', ancestors int32[N])``."""
    offsets, seed = key_tables(key, weights.shape[0], num_iters)
    anc, out = megopolis_fused(weights, to_planes(particles, 1), offsets, seed)
    return from_planes(out, particles), anc


def megopolis_cuda_apply_rows(keys, weights, particles, num_iters: int):
    """Bank form over explicit per-row keys ``[S, 2]``: row ``s`` equals
    ``megopolis_cuda_apply(keys[s], ...)``, in one launch."""
    offsets, seeds = key_tables(keys, weights.shape[1], num_iters)
    anc, out = megopolis_fused_rows(weights, to_planes(particles, 2), offsets, seeds)
    return from_planes(out, particles), anc


def megopolis_cuda_apply_batch(key, weights, particles, num_iters: int):
    """Bank form under one key: the tables of ``megopolis_cuda_batch`` (as
    ``ops.py:133`` of the JAX package), so its ancestors equal
    ``megopolis_cuda_batch``'s."""
    bsz, n = weights.shape
    offsets, seeds = batch_tables(key, bsz, n, num_iters)
    anc, out = megopolis_fused_rows(weights, to_planes(particles, 2),
                                    offsets.expand(bsz, num_iters), seeds)
    return from_planes(out, particles), anc


def megopolis_cuda_step(key, log_weights, particles, num_iters: int, ess_threshold: float):
    """Fused SMC step of one population from UNNORMALISED log-weights:
    returns ``(particles', ancestors, stats f32[4])``, the resample branch
    bit-identical to ``megopolis_cuda_apply(key, exp(lw - max lw), ...)``."""
    offsets, seed = key_tables(key, log_weights.shape[0], num_iters)
    anc, out, stats = megopolis_step(
        log_weights, to_planes(particles, 1), offsets, seed, ess_threshold
    )
    return from_planes(out, particles), anc, stats


def megopolis_cuda_step_rows(keys, log_weights, particles, num_iters: int,
                             ess_threshold: float):
    """Bank form of the step over per-row keys: each row takes its own
    decision; returns ``(particles', ancestors int32[S, N], stats f32[S, 4])``."""
    offsets, seeds = key_tables(keys, log_weights.shape[1], num_iters)
    anc, out, stats = megopolis_step_rows(
        log_weights, to_planes(particles, 2), offsets, seeds, ess_threshold
    )
    return from_planes(out, particles), anc, stats
