"""Typed resampler spec and the built resampler, after ``repro.core.spec``
(the Megopolis family only).

    spec = MegopolisSpec(num_iters=32)          # backend="cuda"
    r = spec.build()
    particles2, ancestors = r.apply(key, weights, particles)
    particles2, ancestors, stats = r.step(key, log_w, particles, 0.5)

The entries follow their inputs' device: CUDA tensors launch the
hand-written kernels, CPU tensors run the kernels' plain versions.  Keys
are ``int64[2]`` (banks ``[S, 2]``) threefry key data (``repro_torch.random``).

What this slice does not port raises ``NotImplementedError`` naming its
ROADMAP item; nothing is computed another way.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Union

import torch

from repro_torch.core.iterations import select_iterations
from repro_torch.core.metrics import (
    degenerate_log_weights,
    normalise_log_weights,
    unique_ancestor_count,
)
from repro_torch.kernels.megopolis.ops import (
    megopolis_cuda_apply,
    megopolis_cuda_apply_batch,
    megopolis_cuda_apply_rows,
    megopolis_cuda_step,
    megopolis_cuda_step_rows,
)
from repro_torch.obs.stats import StepStats, stats_from_vector

AUTO = "auto"
BACKENDS = ("cuda",)
#: The JAX package's backends that have no port yet.
_UNPORTED_BACKENDS = ("reference", "xla", "pallas_interpret", "pallas")
#: Kernel coalescing segment (the TPU's (8, 128) f32 tile, kept for parity).
KERNEL_SEGMENT = 1024
_NEXT_SLICE = (
    "needs the index-only kernels (megopolis_pallas, megopolis_pallas_batch), "
    "which are not ported yet (ROADMAP Queue A, item 1)"
)


def _resolve_iters(num_iters, weights: torch.Tensor) -> int:
    """The iteration count: eq. (3) over concrete weights when 'auto'."""
    return select_iterations(weights) if num_iters == AUTO else num_iters


def _stack(outs):
    return tuple(torch.stack(field) for field in zip(*outs))


class Resampler:
    """A built Megopolis resampler::

        r.apply(key, weights, particles)        # -> (particles', ancestors)
        r.apply_batch(key, weights, particles)  # one shared offset table
        r.apply_rows(keys, weights, particles)  # explicit per-row keys
        r.step(key, log_w, particles, ess_threshold)   # -> (p', ancestors, StepStats)
        r.step_rows(keys, log_w, particles, ess_threshold)

    ``apply`` selects ancestors and copies their state in one launch; row
    ``s`` of ``apply_rows`` equals ``apply(keys[s], ...)``.  ``step``
    normalises, computes the ESS, resamples iff ``ess_norm < threshold``
    (strict) and copies state in one launch; its resample branch equals
    ``apply(key, exp(lw - max lw), particles)``, its no-op branch returns the
    particles with identity ancestors and ``incr = 0``.  The key is consumed
    either way.
    """

    def __init__(self, spec: "MegopolisSpec"):
        self.spec = spec
        self.name = spec.name

    def __call__(self, key, weights):
        raise NotImplementedError(f"{self.name}.__call__ on backend 'cuda' {_NEXT_SLICE}")

    def batch(self, key, weights):
        raise NotImplementedError(f"{self.name}.batch on backend 'cuda' {_NEXT_SLICE}")

    def batch_rows(self, keys, weights):
        raise NotImplementedError(f"{self.name}.batch_rows on backend 'cuda' {_NEXT_SLICE}")

    def _check(self, who: str, weights, particles, lead: int, keys=None):
        if weights.ndim != lead:
            raise ValueError(
                f"{self.name}.{who}: expected {'[N]' if lead == 1 else '[B, N]'} weights; "
                f"got shape {tuple(weights.shape)}"
            )
        if particles.ndim < lead or particles.shape[:lead] != weights.shape:
            raise ValueError(
                f"{self.name}.{who}: particles must lead with the axes of weights; got "
                f"particles {tuple(particles.shape)} for weights {tuple(weights.shape)}"
            )
        if keys is not None and keys.shape != (weights.shape[0], 2):
            raise ValueError(
                f"{self.name}.{who}: expected one key per row, [{weights.shape[0]}, 2]; "
                f"got {tuple(keys.shape)}"
            )

    def apply(self, key, weights, particles):
        """Fused resample + gather of one population."""
        self._check("apply", weights, particles, 1)
        b = _resolve_iters(self.spec.num_iters, weights)
        return megopolis_cuda_apply(key, weights, particles, b)

    def apply_batch(self, key, weights, particles):
        """Bank form under one key, one offset table for the bank ('auto'
        resolves one B over the whole bank, as the JAX kernel path does)."""
        self._check("apply_batch", weights, particles, 2)
        b = _resolve_iters(self.spec.num_iters, weights)
        return megopolis_cuda_apply_batch(key, weights, particles, b)

    def apply_rows(self, keys, weights, particles):
        """``apply`` over explicit per-row keys, in one launch (per-row
        launches under 'auto', so that eq. (3) sees each row)."""
        self._check("apply_rows", weights, particles, 2, keys)
        if self.spec.num_iters == AUTO:
            return _stack([self.apply(keys[s], weights[s], particles[s])
                           for s in range(weights.shape[0])])
        return megopolis_cuda_apply_rows(keys, weights, particles, self.spec.num_iters)

    def step(self, key, log_weights, particles, ess_threshold: float):
        """Fused SMC step of one population: ``(particles', ancestors,
        StepStats)``."""
        self._check("step", log_weights, particles, 1)
        b = _resolve_iters(self.spec.num_iters, normalise_log_weights(log_weights))
        p_out, anc, stats4 = megopolis_cuda_step(key, log_weights, particles, b,
                                                 ess_threshold)
        stats = stats_from_vector(stats4, unique_ancestor_count(anc),
                                  degenerate_log_weights(log_weights))
        return p_out, anc, stats

    def step_rows(self, keys, log_weights, particles, ess_threshold: float):
        """``step`` over explicit per-row keys, each row with its own
        decision; the ``StepStats`` fields are ``[S]``."""
        self._check("step_rows", log_weights, particles, 2, keys)
        if self.spec.num_iters == AUTO:
            outs = [self.step(keys[s], log_weights[s], particles[s], ess_threshold)
                    for s in range(log_weights.shape[0])]
            p_out, anc = _stack([o[:2] for o in outs])
            return p_out, anc, StepStats(*_stack([o[2] for o in outs]))
        p_out, anc, stats4 = megopolis_cuda_step_rows(
            keys, log_weights, particles, self.spec.num_iters, ess_threshold
        )
        stats = stats_from_vector(stats4, unique_ancestor_count(anc),
                                  degenerate_log_weights(log_weights))
        return p_out, anc, stats

    def __repr__(self):
        return f"Resampler({self.spec!r})"


@dataclasses.dataclass(frozen=True)
class MegopolisSpec:
    """The paper's Megopolis resampler (Alg. 5) on the hand-written CUDA
    kernels.  ``segment`` is the kernels' coalescing segment, fixed at 1024
    as on the TPU so that the two agree bit for bit."""

    num_iters: Union[int, str] = AUTO
    segment: int = KERNEL_SEGMENT
    backend: str = "cuda"
    plane_dtype: str = "float32"
    guard: str = "off"

    name: ClassVar[str] = "megopolis"

    def __post_init__(self):
        it = self.num_iters
        if it != AUTO and (isinstance(it, bool) or not isinstance(it, int) or it < 1):
            raise ValueError(
                f"MegopolisSpec.num_iters must be a positive int or {AUTO!r}; got {it!r}"
            )
        if self.backend in _UNPORTED_BACKENDS:
            raise NotImplementedError(
                f"MegopolisSpec.backend={self.backend!r} is not ported yet; the port "
                "runs backend='cuda' (ROADMAP Queue A, item 4: the reference backend)"
            )
        if self.backend not in BACKENDS:
            raise ValueError(f"MegopolisSpec.backend must be one of {BACKENDS}; "
                             f"got {self.backend!r}")
        if self.segment != KERNEL_SEGMENT:
            raise ValueError(
                f"MegopolisSpec: the cuda kernels coalesce at segment={KERNEL_SEGMENT}; "
                f"got segment={self.segment!r}"
            )
        if self.plane_dtype in ("bfloat16", "float16"):
            raise NotImplementedError(
                f"MegopolisSpec.plane_dtype={self.plane_dtype!r} is not ported yet "
                "(ROADMAP Queue A, item 2: compressed planes)"
            )
        if self.plane_dtype != "float32":
            raise ValueError(f"MegopolisSpec.plane_dtype must be 'float32'; "
                             f"got {self.plane_dtype!r}")
        if self.guard in ("flag", "recover"):
            raise NotImplementedError(
                f"MegopolisSpec.guard={self.guard!r} is not ported yet "
                "(ROADMAP Queue A, item 3: degeneracy guards)"
            )
        if self.guard != "off":
            raise ValueError(f"MegopolisSpec.guard must be 'off'; got {self.guard!r}")

    def replace(self, **changes) -> "MegopolisSpec":
        """A validated copy with ``changes`` applied."""
        return dataclasses.replace(self, **changes)

    def build(self) -> Resampler:
        return Resampler(self)
