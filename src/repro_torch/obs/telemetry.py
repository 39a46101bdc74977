"""``Telemetry``, the trajectory record of a run, after
``repro.obs.telemetry``:

- ``run_filter`` / ``run_filter_bank``: ``steps`` holds one ``StepStats``
  per observation (``[T]`` per field; banks ``[S, T]``);
- ``run_smc_sampler`` / ``_bank``: ``steps`` per temperature, plus
  ``accept`` (the move's acceptance rate per temperature) and ``betas``
  (the β ladder visited), laid out as ``steps``.

The record is built from values the loops compute anyway: enabling it adds
no kernel launch and leaves every other output bit-identical (pass 6 of the
contract checks)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.obs.stats import StepStats


class Telemetry(NamedTuple):
    steps: StepStats
    accept: Optional[torch.Tensor] = None
    betas: Optional[torch.Tensor] = None
