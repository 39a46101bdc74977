"""``StepStats``, the per-step SMC diagnostic record, after
``repro.obs.stats``.

- ``ess_norm``           f32, ESS/N of the input log-weights (the trigger);
- ``log_evidence_incr``  f32, ``log(mean(exp(log_w)))`` when the step
  resampled, else 0;
- ``resampled``          f32, 1.0 when the trigger fired, else 0.0;
- ``max_weight``         f32, the largest normalised weight;
- ``survivors``          int32, the number of distinct ancestors;
- ``degenerate``         bool, the input bank carried no usable information.

The first four fields are the step kernel's stats vector ``f32[..., 4]``;
the last two are composed by the caller.  Batched records hold ``[S]`` (or
``[S, T]``) tensors per field.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class StepStats(NamedTuple):
    ess_norm: torch.Tensor
    log_evidence_incr: torch.Tensor
    resampled: torch.Tensor
    max_weight: torch.Tensor
    survivors: torch.Tensor
    degenerate: torch.Tensor


def stats_from_vector(stats4: torch.Tensor, survivors: torch.Tensor,
                      degenerate: Optional[torch.Tensor] = None) -> StepStats:
    """Unpack a kernel stats vector ``f32[..., 4]`` plus the survivor count
    (and degenerate flag, default all False) into a ``StepStats``."""
    if degenerate is None:
        degenerate = torch.zeros(survivors.shape, dtype=torch.bool, device=survivors.device)
    return StepStats(
        ess_norm=stats4[..., 0],
        log_evidence_incr=stats4[..., 1],
        resampled=stats4[..., 2],
        max_weight=stats4[..., 3],
        survivors=survivors,
        degenerate=degenerate,
    )


def stack_stats(records, dim: int = -1) -> StepStats:
    """Stack per-step records along a new time axis ``dim``."""
    return StepStats(*(torch.stack(field, dim=dim) for field in zip(*records)))
