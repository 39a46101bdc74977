"""Rejection resampling (Murray), the reference algorithm, after
``repro.core.resamplers.rejection``.

Unbiased, needs ``sup w``, variable time: each particle first proposes
itself (accept with probability ``w_i / sup w``), then draws uniform
proposals until its first accept, at most ``max_iters`` rounds; a particle
that never accepts keeps its own index (the code's behaviour, ROADMAP
Queue C item 12).  The draws are JAX's streams, the round loop ends when
every particle is done or at the cap, as the JAX ``while_loop`` does.
"""

from __future__ import annotations

import torch

from repro_torch import random as trandom
from repro_torch.core.resamplers.batched import batch_via_vmap
from repro_torch.kernels.common import flush_to_zero


def rejection(key: torch.Tensor, weights: torch.Tensor, num_iters: int = 0, *,
              max_iters: int = 1024) -> torch.Tensor:
    """Returns ancestors ``int32[N]``.  ``num_iters`` ignored (API
    uniformity)."""
    del num_iters
    n = weights.shape[0]
    w = flush_to_zero(weights.to(torch.float32))
    w_max = w.amax()
    key_init, key_loop = trandom.split(key)
    k = torch.arange(n, dtype=torch.int64, device=w.device)
    u0 = trandom.uniform(key_init, (n,), device=w.device)
    done = flush_to_zero(u0 * w_max) <= w
    t = 0
    while t < max_iters and not bool(done.all()):
        kj, ku = trandom.split(trandom.fold_in(key_loop, t))
        j = trandom.randint(kj, (n,), 0, n, device=w.device).long()
        u = trandom.uniform(ku, (n,), device=w.device)
        accept = ~done & (flush_to_zero(u * w_max) <= w[j])
        k = torch.where(accept, j, k)
        done = done | accept
        t += 1
    return k.to(torch.int32)


rejection_batch = batch_via_vmap(rejection)
