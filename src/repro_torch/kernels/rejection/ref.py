"""Plain PyTorch versions of the rejection CUDA kernels, on the same
signatures (after ``repro.kernels.rejection.ref.rejection_ref``).

Murray's rejection resampler, term for term as the JAX package's: the
inputs flushed, ``sup w = max(w)`` of the flushed row; round 0 is the
self-proposal, accepted when ``u0·sup w <= w[i]``; rounds ``t = 1 ..
max_iters`` propose ``j = hash_bits(seed, i, t) mod N`` and accept when
``u·sup w <= w[j]``, ``u = hash_uniform(seed, i + N, t)`` (the Metropolis
hash lanes of ``kernels/metropolis/ref.py``), each lane only until its
first accept.  A lane that never accepts keeps its own index ``i``, as the
JAX code does.

The product ``u·sup w`` is taken in the order XLA gives it on the CPU.
``u`` is ``(bits >> 8)·2**-24`` and ``sup w`` a scalar, so XLA folds the
two scalars first: ``(bits >> 8)·flush(sup w·2**-24)``.  Both factors are
exact while ``sup w·2**-24`` is normal, so this is the same product, bit
for bit; below ``sup w = 2**-102`` the folded scalar flushes to zero, and
every lane accepts its self-proposal.  The port computes it the same way
(ROADMAP Queue C, item 13).

The TPU kernel runs every lane through all ``max_iters`` rounds under a done
mask; nothing changes after a lane's accept, so these versions follow only
the lanes still running and stop when none is left, with the same result.
That keeps them usable at N = 2**20 on the card, where ``chip_smoke.py``
holds the kernels against them.

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
    step_select,
    step_weights,
    tile_lane_ids,
)
from repro_torch.kernels.metropolis.ref import proposal_index

#: 2**-24, the scale of ``hash_uniform``'s 24 bits.
_U_SCALE = 1.0 / (1 << 24)


def scaled_uniform(seeds, i, n: int, t: int, scale: torch.Tensor) -> torch.Tensor:
    """``u·sup w`` of lane ``i`` at round ``t``, as XLA computes it:
    ``flush((bits >> 8)·scale)`` with ``scale = flush(sup w·2**-24)`` and
    ``bits`` the accept lane ``(uint32)(i + N)`` of the hash stream."""
    bits = hash_bits(seeds, (i + n) & MASK32, t)
    return flush_to_zero((bits >> 8).to(torch.float32) * scale)


def _chain(w: torch.Tensor, w_max: torch.Tensor, seeds: torch.Tensor, max_iters: int):
    """The rejection chain over flushed ``w[S, N]`` with ``sup w`` per row
    ``w_max[S]``: ``(ancestors int64[S, N], rounds int64[S, N])``, where
    ``rounds`` is the round of each lane's accept, or ``max_iters`` if it
    never accepted."""
    s, n = w.shape
    i = tile_lane_ids(n, w.device).to(torch.int64).unsqueeze(0)
    seeds = seeds.to(device=w.device, dtype=torch.int64).unsqueeze(-1)
    scale = flush_to_zero(w_max * _U_SCALE).unsqueeze(-1)
    done = scaled_uniform(seeds, i, n, 0, scale) <= w  # round 0: j = i
    k = i.expand(s, n).clone()
    rounds = torch.where(done, 0, max_iters).view(-1)
    # The lanes still running, as flat indices s·N + i.
    live = torch.nonzero(~done.view(-1)).squeeze(1)
    k, w_flat, scale, seeds = k.view(-1), w.reshape(-1), scale.view(-1), seeds.view(-1)
    for t in range(1, max_iters + 1):
        if live.numel() == 0:
            break
        row, lane = live // n, live % n
        j = proposal_index(seeds[row], lane, n, t)
        w_j = w_flat[row * n + j]
        accept = scaled_uniform(seeds[row], lane, n, t, scale[row]) <= w_j
        hit = live[accept]
        k[hit] = j[accept]
        rounds[hit] = t
        live = live[~accept]
    return k.view(s, n), rounds.view(s, n)


def _flushed(w: torch.Tensor):
    w = flush_to_zero(w.to(torch.float32))
    return w, w.amax(dim=-1)


def rejection_rows_ref(w: torch.Tensor, state: Optional[torch.Tensor], seeds: torch.Tensor,
                       max_iters: int):
    """Plain version of ``rejection_rows_kernel``: ancestors ``int32[S, N]``
    when ``state`` is None (index only), else ``(ancestors, state' [S, D,
    N])``."""
    k, _ = _chain(*_flushed(w), seeds, max_iters)
    if state is None:
        return k.to(torch.int32)
    return k.to(torch.int32), gather_state(state, k)


def rejection_step_rows_ref(lw: torch.Tensor, state: torch.Tensor, seeds: torch.Tensor,
                            max_iters: int, thr: float):
    """Plain version of ``rejection_step_rows_kernel``: ``step_stats`` per
    row, the trigger ``ess_norm < thr``, the chain on ``exp(lw - m)``
    (uniform ``1/N`` on a degenerate row) with ``sup w`` the literal max of
    those weights, then the selection or the identity.  Returns
    ``(ancestors int32[S, N], state' [S, D, N], stats f32[S, 4])``."""
    w, do, stats = step_weights(lw, thr)
    k, _ = _chain(w, w.amax(dim=-1), seeds, max_iters)
    k = step_select(do, k)
    return k.to(torch.int32), gather_state(state, k), stats


def rejection_rounds_ref(w: torch.Tensor, seeds: torch.Tensor, max_iters: int,
                         log_weights: bool = False, thr: float = 1.0) -> torch.Tensor:
    """The round at which each lane of a bank accepted, ``int64[S, N]`` (0
    for the self-proposal), or ``max_iters`` if it never did: the lane ran
    ``rounds + 1`` rounds, its warp as many as its slowest lane.  With
    ``log_weights`` the chain runs on the step's weights ``exp(lw - m)``,
    and a row whose trigger ``ess_norm < thr`` did not fire runs no round
    (-1)."""
    if not log_weights:
        return _chain(*_flushed(w), seeds, max_iters)[1]
    wn, do, _ = step_weights(w, thr)
    rounds = _chain(wn, wn.amax(dim=-1), seeds, max_iters)[1]
    return torch.where(do.unsqueeze(-1), rounds, -1)
