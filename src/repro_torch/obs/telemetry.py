"""``Telemetry``, the trajectory record of a filter run, after
``repro.obs.telemetry``: ``steps`` holds one ``StepStats`` per observation
(``[T]`` per field; banks ``[S, T]``).  The AIS fields of the JAX record
(``accept``, ``betas``) come with the AIS port (ROADMAP Queue A, item 8)."""

from __future__ import annotations

from typing import NamedTuple

from repro_torch.obs.stats import StepStats


class Telemetry(NamedTuple):
    steps: StepStats
