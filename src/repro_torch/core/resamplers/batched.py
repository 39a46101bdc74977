"""The batched (multi-population) resampling contract, after
``repro.core.resamplers.batched`` (DESIGN.md §4).

Every resampler has a bank form over ``weights[B, N]``: the key splits once
along the batch axis, ``keys = split(key, B)``, and row ``b`` equals the
single-population call with ``keys[b]``.  The JAX package derives the bank
forms with ``jax.vmap``; this module's forms run the rows one after the
other, the algorithm oracle for the port (the kernels' bank launches are
the fast path).
"""

from __future__ import annotations

import functools

import torch

from repro_torch import random as trandom


def split_batch_keys(key: torch.Tensor, batch: int) -> torch.Tensor:
    """The one key-splitting convention of the bank entries: row ``b`` of a
    bank runs with ``split(key, B)[b]``."""
    return trandom.split(key, batch)


def batch_rows(fn, keys: torch.Tensor, weights: torch.Tensor, num_iters=0, **kwargs):
    """``fn`` over explicit per-row keys: row ``b`` is ``fn(keys[b],
    weights[b], num_iters, **kwargs)``, stacked to ``int32[B, N]``."""
    if weights.ndim != 2:
        raise ValueError(
            f"batched resampling expects weights[B, N]; got shape {tuple(weights.shape)}")
    return torch.stack([fn(keys[b], weights[b], num_iters, **kwargs)
                        for b in range(weights.shape[0])])


def batch_via_vmap(fn):
    """The standard bank form of a single-population resampler: split the
    key along the rows, then ``batch_rows``.  (The name is the JAX
    package's; the rows run one after the other.)"""

    @functools.wraps(fn)
    def resample_batch(key: torch.Tensor, weights: torch.Tensor, num_iters=0, **kwargs):
        keys = split_batch_keys(key, weights.shape[0])
        return batch_rows(fn, keys, weights, num_iters, **kwargs)

    resample_batch.__name__ = f"{fn.__name__}_batch"
    resample_batch.__qualname__ = f"{fn.__name__}_batch"
    resample_batch.__doc__ = (
        f"Batched {fn.__name__} over weights[B, N]: row b equals "
        f"{fn.__name__}(split(key, B)[b], weights[b], ...).")
    return resample_batch
