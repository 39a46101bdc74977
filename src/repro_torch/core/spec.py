"""Typed resampler specs and the built resampler, after ``repro.core.spec``
(the Megopolis and Metropolis families).

    spec = MegopolisSpec(num_iters=32)          # backend="cuda"
    r = spec.build()
    ancestors = r(key, weights)
    particles2, ancestors = r.apply(key, weights, particles)
    particles2, ancestors, stats = r.step(key, log_w, particles, 0.5)

The entries follow their inputs' device: CUDA tensors launch the
hand-written kernels, CPU tensors run the kernels' plain versions.  Keys
are ``int64[2]`` (banks ``[S, 2]``) threefry key data (``repro_torch.random``).

What is not ported raises ``NotImplementedError`` naming its ROADMAP item;
nothing is computed another way.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, Union

import torch

from repro_torch.core.iterations import select_iterations
from repro_torch.core.metrics import (
    degenerate_log_weights,
    normalise_log_weights,
    unique_ancestor_count,
)
from repro_torch.core.resamplers.batched import split_batch_keys
from repro_torch.kernels.megopolis import ops as mops
from repro_torch.kernels.metropolis import ops as tops
from repro_torch.obs.stats import stats_from_vector

AUTO = "auto"
BACKENDS = ("cuda",)
#: The JAX package's backends that have no port yet.
_UNPORTED_BACKENDS = ("reference", "xla", "pallas_interpret", "pallas")
#: Kernel coalescing segment (the TPU's (8, 128) f32 tile, kept for parity).
KERNEL_SEGMENT = 1024


def _resolve_iters(num_iters, weights: torch.Tensor) -> int:
    """The iteration count: eq. (3) over concrete weights when 'auto'."""
    return select_iterations(weights) if num_iters == AUTO else num_iters


def _row_by_row(fn: Callable, split_key: bool) -> Callable:
    """A bank form that launches ``fn`` once per row, so that eq. (3) sees
    each row's weights under 'auto' (``_per_row_auto_*`` of the JAX spec).
    The keys are ``split(key, S)`` when ``split_key``, else the given
    per-row keys; tensor arguments after the weights are taken row by row,
    others (the ESS threshold) passed as they are."""

    def rows(key, w, *rest):
        keys = split_batch_keys(key, w.shape[0]) if split_key else key
        outs = [fn(keys[s], w[s], *(a[s] if torch.is_tensor(a) else a for a in rest))
                for s in range(w.shape[0])]
        if torch.is_tensor(outs[0]):
            return torch.stack(outs)
        return tuple(torch.stack(field) for field in zip(*outs))

    return rows


def _auto_batch_rows(name: str) -> Callable:
    """``batch_rows`` under 'auto': the JAX package maps the single call
    over the rows (``jax.vmap``), which hands it traced weights, and its
    kernel path raises ``TypeError`` there; so does the port."""

    def batch_rows(keys, w):
        raise TypeError(
            f"{name}.batch_rows: num_iters='auto' needs each row's B before the launch "
            "(the JAX package's vmapped single call raises TypeError here); pass an int "
            "num_iters"
        )

    return batch_rows


class Resampler:
    """A built resampler, one class for every family; the family's
    ``build`` supplies the entries::

        r(key, weights)                         # -> ancestors int32[N]
        r.batch(key, weights)                   # bank under one key
        r.batch_rows(keys, weights)             # explicit per-row keys
        r.apply(key, weights, particles)        # -> (particles', ancestors)
        r.apply_batch(key, weights, particles)
        r.apply_rows(keys, weights, particles)
        r.step(key, log_w, particles, ess_threshold)   # -> (p', ancestors, StepStats)
        r.step_rows(keys, log_w, particles, ess_threshold)

    Row ``s`` of ``batch_rows``/``apply_rows``/``step_rows`` equals the
    single entry with ``keys[s]``.  ``batch``/``apply_batch`` follow the
    family's contract: Metropolis's row ``s`` is the single call with
    ``split(key, S)[s]``; Megopolis's shares one offset table over the bank.
    ``apply`` selects ancestors and copies their state in one launch, with
    the ancestors of ``__call__``.  ``step`` normalises, computes the ESS,
    resamples iff ``ess_norm < threshold`` (strict) and copies state in one
    launch; its resample branch equals ``apply(key, exp(lw - max lw),
    particles)``, its no-op branch returns the particles with identity
    ancestors and ``incr = 0``.  The key is consumed either way.
    """

    def __init__(self, spec: "ResamplerSpec", *, single: Callable, batch: Callable,
                 batch_rows: Callable, apply: Callable, apply_batch: Callable,
                 apply_rows: Callable, step: Callable, step_rows: Callable):
        self.spec = spec
        self.name = spec.name
        self._single = single
        self._batch = batch
        self._batch_rows = batch_rows
        self._apply = apply
        self._apply_batch = apply_batch
        self._apply_rows = apply_rows
        self._step = step
        self._step_rows = step_rows

    def _check(self, who: str, weights, lead: int, particles=None, keys=None):
        if weights.ndim != lead:
            raise ValueError(
                f"{self.name}.{who}: expected {'[N]' if lead == 1 else '[B, N]'} weights; "
                f"got shape {tuple(weights.shape)}"
            )
        if particles is not None and (particles.ndim < lead
                                      or particles.shape[:lead] != weights.shape):
            raise ValueError(
                f"{self.name}.{who}: particles must lead with the axes of weights; got "
                f"particles {tuple(particles.shape)} for weights {tuple(weights.shape)}"
            )
        if keys is not None and keys.shape != (weights.shape[0], 2):
            raise ValueError(
                f"{self.name}.{who}: expected one key per row, [{weights.shape[0]}, 2]; "
                f"got {tuple(keys.shape)}"
            )

    def __call__(self, key, weights):
        """Index-only resample of one population: ancestors ``int32[N]``."""
        self._check("__call__", weights, 1)
        return self._single(key, weights)

    def batch(self, key, weights):
        """Index-only resample of a bank ``[S, N]`` under one key."""
        self._check("batch", weights, 2)
        return self._batch(key, weights)

    def batch_rows(self, keys, weights):
        """Index-only resample of a bank over explicit per-row keys."""
        self._check("batch_rows", weights, 2, keys=keys)
        return self._batch_rows(keys, weights)

    def apply(self, key, weights, particles):
        """Fused resample + gather of one population."""
        self._check("apply", weights, 1, particles)
        return self._apply(key, weights, particles)

    def apply_batch(self, key, weights, particles):
        """Bank form of ``apply`` under one key."""
        self._check("apply_batch", weights, 2, particles)
        return self._apply_batch(key, weights, particles)

    def apply_rows(self, keys, weights, particles):
        """``apply`` over explicit per-row keys."""
        self._check("apply_rows", weights, 2, particles, keys)
        return self._apply_rows(keys, weights, particles)

    def step(self, key, log_weights, particles, ess_threshold: float):
        """Fused SMC step of one population: ``(particles', ancestors,
        StepStats)``."""
        self._check("step", log_weights, 1, particles)
        p_out, anc, stats4 = self._step(key, log_weights, particles, ess_threshold)
        stats = stats_from_vector(stats4, unique_ancestor_count(anc),
                                  degenerate_log_weights(log_weights))
        return p_out, anc, stats

    def step_rows(self, keys, log_weights, particles, ess_threshold: float):
        """``step`` over explicit per-row keys, each row with its own
        decision; the ``StepStats`` fields are ``[S]``."""
        self._check("step_rows", log_weights, 2, particles, keys)
        p_out, anc, stats4 = self._step_rows(keys, log_weights, particles, ess_threshold)
        stats = stats_from_vector(stats4, unique_ancestor_count(anc),
                                  degenerate_log_weights(log_weights))
        return p_out, anc, stats

    def __repr__(self):
        return f"Resampler({self.spec!r})"


@dataclasses.dataclass(frozen=True)
class ResamplerSpec:
    """Base class: a frozen spec of one resampler family on the port's
    ``cuda`` backend.  Subclasses add their fields and ``build``."""

    name: ClassVar[str] = ""

    def _validate(self):
        """The checks every family shares: ``num_iters``, ``backend``,
        ``plane_dtype`` and ``guard``; values the port does not have yet
        raise ``NotImplementedError`` naming their ROADMAP item."""
        cls = type(self).__name__
        it = self.num_iters
        if it != AUTO and (isinstance(it, bool) or not isinstance(it, int) or it < 1):
            raise ValueError(f"{cls}.num_iters must be a positive int or {AUTO!r}; got {it!r}")
        if self.backend in _UNPORTED_BACKENDS:
            raise NotImplementedError(
                f"{cls}.backend={self.backend!r} is not ported yet; the port "
                "runs backend='cuda' (ROADMAP Queue A, item 4: the reference backend)"
            )
        if self.backend not in BACKENDS:
            raise ValueError(f"{cls}.backend must be one of {BACKENDS}; got {self.backend!r}")
        if self.plane_dtype in ("bfloat16", "float16"):
            raise NotImplementedError(
                f"{cls}.plane_dtype={self.plane_dtype!r} is not ported yet "
                "(ROADMAP Queue A, item 2: compressed planes)"
            )
        if self.plane_dtype != "float32":
            raise ValueError(f"{cls}.plane_dtype must be 'float32'; got {self.plane_dtype!r}")
        if self.guard in ("flag", "recover"):
            raise NotImplementedError(
                f"{cls}.guard={self.guard!r} is not ported yet "
                "(ROADMAP Queue A, item 3: degeneracy guards)"
            )
        if self.guard != "off":
            raise ValueError(f"{cls}.guard must be 'off'; got {self.guard!r}")

    def replace(self, **changes) -> "ResamplerSpec":
        """A validated copy with ``changes`` applied."""
        return dataclasses.replace(self, **changes)

    def build(self) -> Resampler:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class MegopolisSpec(ResamplerSpec):
    """The paper's Megopolis resampler (Alg. 5) on the hand-written CUDA
    kernels.  ``segment`` is the kernels' coalescing segment, fixed at 1024
    as on the TPU so that the two agree bit for bit.

    'auto' resolves eq. (3) per call; ``batch``/``apply_batch`` resolve one
    B for the whole bank (one shared offset table), ``apply_rows`` and
    ``step_rows`` launch row by row."""

    num_iters: Union[int, str] = AUTO
    segment: int = KERNEL_SEGMENT
    backend: str = "cuda"
    plane_dtype: str = "float32"
    guard: str = "off"

    name: ClassVar[str] = "megopolis"

    def __post_init__(self):
        self._validate()
        if self.segment != KERNEL_SEGMENT:
            raise ValueError(
                f"MegopolisSpec: the cuda kernels coalesce at segment={KERNEL_SEGMENT}; "
                f"got segment={self.segment!r}"
            )

    def build(self) -> Resampler:
        it = self.num_iters

        def single(key, w):
            return mops.megopolis_cuda(key, w, _resolve_iters(it, w))

        def batch(key, w):
            return mops.megopolis_cuda_batch(key, w, _resolve_iters(it, w))

        def apply(key, w, p):
            return mops.megopolis_cuda_apply(key, w, p, _resolve_iters(it, w))

        def apply_batch(key, w, p):
            return mops.megopolis_cuda_apply_batch(key, w, p, _resolve_iters(it, w))

        def step(key, lw, p, thr):
            b = _resolve_iters(it, normalise_log_weights(lw))
            return mops.megopolis_cuda_step(key, lw, p, b, thr)

        if it == AUTO:
            return Resampler(self, single=single, batch=batch,
                             batch_rows=_auto_batch_rows(self.name), apply=apply,
                             apply_batch=apply_batch, apply_rows=_row_by_row(apply, False),
                             step=step, step_rows=_row_by_row(step, False))
        return Resampler(
            self, single=single, batch=batch,
            batch_rows=lambda keys, w: mops.megopolis_cuda_batch_rows(keys, w, it),
            apply=apply, apply_batch=apply_batch,
            apply_rows=lambda keys, w, p: mops.megopolis_cuda_apply_rows(keys, w, p, it),
            step=step,
            step_rows=lambda keys, lw, p, thr: mops.megopolis_cuda_step_rows(
                keys, lw, p, it, thr),
        )


@dataclasses.dataclass(frozen=True)
class MetropolisSpec(ResamplerSpec):
    """The paper's random-access Metropolis baseline (Alg. 2) on the
    hand-written CUDA kernels.

    'auto' resolves eq. (3) per call, and every bank form launches row by
    row so that each row gets its own B (``batch``/``apply_batch`` still
    under the split-key contract)."""

    num_iters: Union[int, str] = AUTO
    backend: str = "cuda"
    plane_dtype: str = "float32"
    guard: str = "off"

    name: ClassVar[str] = "metropolis"

    def __post_init__(self):
        self._validate()

    def build(self) -> Resampler:
        it = self.num_iters

        def single(key, w):
            return tops.metropolis_cuda(key, w, _resolve_iters(it, w))

        def apply(key, w, p):
            return tops.metropolis_cuda_apply(key, w, p, _resolve_iters(it, w))

        def step(key, lw, p, thr):
            b = _resolve_iters(it, normalise_log_weights(lw))
            return tops.metropolis_cuda_step(key, lw, p, b, thr)

        if it == AUTO:
            return Resampler(self, single=single, batch=_row_by_row(single, True),
                             batch_rows=_auto_batch_rows(self.name), apply=apply,
                             apply_batch=_row_by_row(apply, True),
                             apply_rows=_row_by_row(apply, False),
                             step=step, step_rows=_row_by_row(step, False))
        return Resampler(
            self, single=single,
            batch=lambda key, w: tops.metropolis_cuda_batch(key, w, it),
            batch_rows=lambda keys, w: tops.metropolis_cuda_batch_rows(keys, w, it),
            apply=apply,
            apply_batch=lambda key, w, p: tops.metropolis_cuda_apply_batch(key, w, p, it),
            apply_rows=lambda keys, w, p: tops.metropolis_cuda_apply_rows(keys, w, p, it),
            step=step,
            step_rows=lambda keys, lw, p, thr: tops.metropolis_cuda_step_rows(
                keys, lw, p, it, thr),
        )
