"""The key convention of the batched API, after
``repro.core.resamplers.batched``."""

from __future__ import annotations

import torch

from repro_torch import random as trandom


def split_batch_keys(key: torch.Tensor, batch: int) -> torch.Tensor:
    """The one key-splitting convention of the bank entries: row ``b`` of a
    bank runs with ``split(key, B)[b]``."""
    return trandom.split(key, batch)
