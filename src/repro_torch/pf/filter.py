"""SIR / bootstrap particle filter (paper Algorithms 1 and 6), after
``repro.pf.filter``.

The modified SIR filter (Alg. 6) drops weight normalisation and estimates
the state as the post-resampling particle mean.  With ``ess_threshold`` set
it runs classic conditional SIR: log-weights accumulate and the fused
``Resampler.step`` resamples when the normalised ESS drops below the
threshold.

  * ``run_filter``: one filter, a Python loop over time steps (JAX's
    ``lax.scan``); one fused kernel launch per step.
  * ``run_filter_bank``: S independent filters with an explicit scenario
    axis (JAX's ``vmap``); one bank launch per step.
  * ``run_filter_timed``: per-stage timing for the Resample-Ratio metric
    (eq. 25), with ``torch.cuda.synchronize()`` at each stage boundary.

Key chains follow the JAX filter split for split, so that the same key
consumes the same randomness.  The loops never wait on the card except
where ``num_iters="auto"`` resolves eq. (3) (one ``.item()``).

Device rule: these entries take ``device="cuda"`` and raise without a card
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Union

import torch

from repro_torch import random as trandom
from repro_torch import resolve_device
from repro_torch.core.metrics import (
    degenerate_weights,
    effective_sample_size,
    log_mean_weight,
    log_weights_from_linear,
    max_normalised_weight,
    normalise_log_weights,
    unique_ancestor_count,
)
from repro_torch.core.resamplers.batched import split_batch_keys
from repro_torch.core.spec import MegopolisSpec, ResamplerSpec, coerce_spec
from repro_torch.obs.stats import StepStats, stack_stats
from repro_torch.obs.telemetry import Telemetry

#: B of a resampler given by name, the fixed application prior of paper §7
#: (the JAX filter's default ``num_iters``).
NAMED_NUM_ITERS = 30


@dataclasses.dataclass(frozen=True)
class StateSpaceModel:
    transition: Callable  # (key, x[N], t) -> x[N]
    observe: Callable  # (key, x[], t) -> z[]       (for ground-truth sim)
    likelihood: Callable  # (z, x[N], t) -> w[N]       (unnormalised)
    init: Callable  # (key, n, device) -> x[N]
    name: str = "model"


@dataclasses.dataclass(frozen=True)
class ParticleFilter:
    """SIR filter config.  ``resampler`` is a spec of any family on either
    backend (default ``MegopolisSpec(num_iters=30)``, the fixed prior of
    paper §7): a ``MegopolisSpec``, a ``MetropolisSpec`` (the paper's Alg. 2
    baseline, Table 2), a ``MetropolisC1Spec`` / ``MetropolisC2Spec``
    (Algs. 3-4, Fig. 9), a ``RejectionSpec`` (Murray's rejection, paper §1)
    or a ``PrefixSumSpec`` (the prefix-sum kinds of paper §6.5); or a
    registry name, resolved through ``coerce_spec(name, num_iters=30)``
    (``"megopolis"``, ``"residual"``, ...)."""

    model: StateSpaceModel
    num_particles: int
    resampler: Union[str, ResamplerSpec] = MegopolisSpec(num_iters=NAMED_NUM_ITERS)
    # None keeps Alg. 6's unconditional resample; a float in [0, 1] runs
    # conditional SIR with one fused step launch per time step.
    ess_threshold: Optional[float] = None

    def __post_init__(self):
        if self.ess_threshold is not None and not 0.0 <= self.ess_threshold <= 1.0:
            raise ValueError(
                "ParticleFilter.ess_threshold must be in [0, 1] (a normalised "
                f"ESS fraction) or None for Alg. 6; got {self.ess_threshold}"
            )
        spec = self.resampler
        if isinstance(spec, str):
            spec = coerce_spec(spec, num_iters=NAMED_NUM_ITERS)
        elif not isinstance(spec, ResamplerSpec):
            raise TypeError(
                f"ParticleFilter: resampler must be a registry name or a ResamplerSpec; "
                f"got {type(spec).__name__}")
        object.__setattr__(self, "_built", spec.build())

    @property
    def spec(self) -> ResamplerSpec:
        return self._built.spec

    def step(self, key, particles, z, t, theta=None):
        """One SIR step (Alg. 6): ``(particles', estimate, weights,
        ancestors)``; stage 2 is the fused ``Resampler.apply``."""
        k_pred, k_res = trandom.split(key)
        x = _call(self.model.transition, k_pred, particles, t, theta=theta)
        w = _call(self.model.likelihood, z, x, t, theta=theta)
        x_bar, ancestors = self._built.apply(k_res, w, x)
        return x_bar, x_bar.mean(), w, ancestors

    def step_conditional(self, key, particles, log_w, z, t, theta=None):
        """One conditional-SIR step: ``(particles', log_w', estimate,
        stats)``; the estimate is the weighted mean over the pre-resample
        weights, stage 2 the fused ``Resampler.step``."""
        k_pred, k_res = trandom.split(key)
        x = _call(self.model.transition, k_pred, particles, t, theta=theta)
        w = _call(self.model.likelihood, z, x, t, theta=theta)
        log_w = log_w + log_weights_from_linear(w)
        wn = normalise_log_weights(log_w)
        est = (wn * x).sum() / wn.sum()
        x_bar, _, stats = self._built.step(k_res, log_w, x, self.ess_threshold)
        log_w = torch.where(stats.ess_norm < self.ess_threshold, torch.zeros_like(log_w), log_w)
        return x_bar, log_w, est, stats


def _call(fn, *args, theta=None):
    return fn(*args) if theta is None else fn(*args, theta)


def _times(num_steps: int, device) -> torch.Tensor:
    return torch.arange(1, num_steps + 1, dtype=torch.float32, device=device)


def simulate(key, model: StateSpaceModel, num_steps: int, theta=None, device="cuda"):
    """Ground-truth trajectory and observations, ``(xs[T], zs[T])``."""
    dev = resolve_device(device)
    k0, k = trandom.split(key)
    x = model.init(k0, 1, dev)[0]
    xs, zs = [], []
    for t in _times(num_steps, dev):
        k, k1, k2 = trandom.split(k, 3)
        x = _call(model.transition, k1, x, t, theta=theta)
        xs.append(x)
        zs.append(_call(model.observe, k2, x, t, theta=theta))
    return torch.stack(xs), torch.stack(zs)


def _alg6_step_stats(w: torch.Tensor, ancestors: torch.Tensor) -> StepStats:
    """The ``StepStats`` of an unconditional (Alg. 6) step, composed from
    the weights and ancestors the step produced (rows for a bank)."""
    lw = log_weights_from_linear(w)
    n = w.shape[-1]
    return StepStats(
        ess_norm=effective_sample_size(lw) / float(n),
        log_evidence_incr=log_mean_weight(lw),
        resampled=torch.ones(w.shape[:-1], dtype=torch.float32, device=w.device),
        max_weight=max_normalised_weight(lw),
        survivors=unique_ancestor_count(ancestors),
        degenerate=degenerate_weights(w),
    )


def run_filter(key, pf: ParticleFilter, observations, theta=None, telemetry: bool = False,
               with_ess: bool = False, checkpoint=None, device="cuda"):
    """Filter one observation stream; returns estimates ``f32[T]`` (and a
    ``Telemetry`` with ``[T]`` fields when ``telemetry=True``)."""
    if checkpoint is not None:
        raise NotImplementedError(
            "run_filter(checkpoint=...) is not ported yet (ROADMAP Queue A, item 7)"
        )
    if with_ess:
        raise NotImplementedError(
            "run_filter(with_ess=True) is deprecated in the JAX package and not "
            "ported; use telemetry=True and read Telemetry.steps.ess_norm"
        )
    dev = resolve_device(device)
    observations = torch.as_tensor(observations, dtype=torch.float32).to(dev)
    conditional = pf.ess_threshold is not None
    k0, k = trandom.split(key)
    particles = pf.model.init(k0, pf.num_particles, dev)
    log_w = torch.zeros(pf.num_particles, dtype=torch.float32, device=dev)
    ests, records = [], []
    for t, z in zip(_times(observations.shape[0], dev), observations):
        k, ks = trandom.split(k)
        if conditional:
            particles, log_w, est, stats = pf.step_conditional(ks, particles, log_w, z, t,
                                                               theta=theta)
        else:
            particles, est, w, ancestors = pf.step(ks, particles, z, t, theta=theta)
            stats = _alg6_step_stats(w, ancestors) if telemetry else None
        ests.append(est)
        records.append(stats)
    ests = torch.stack(ests)
    if not telemetry:
        return ests
    return ests, Telemetry(steps=stack_stats(records, dim=0))


def run_filter_bank(key, pf: ParticleFilter, observations, thetas=None,
                    telemetry: bool = False, device="cuda"):
    """S independent filters with one bank launch per step; returns
    estimates ``f32[S, T]`` (and a ``Telemetry`` with ``[S, T]`` fields).

    ``observations`` is ``[S, T]``; ``thetas`` (optional) a dict of ``[S]``
    per-scenario parameters.  The key splits once along the scenario axis,
    so row ``s`` follows ``run_filter(split(key, S)[s], ...)``."""
    dev = resolve_device(device)
    observations = torch.as_tensor(observations, dtype=torch.float32).to(dev)
    num_s = observations.shape[0]
    resampler = pf._built
    conditional = pf.ess_threshold is not None
    if thetas is not None:
        thetas = {name: torch.as_tensor(v, dtype=torch.float32).reshape(num_s, 1).to(dev)
                  for name, v in thetas.items()}
    halves = trandom.split(split_batch_keys(key, num_s))
    particles = pf.model.init(halves[:, 0], pf.num_particles, dev)
    ks = halves[:, 1]
    log_w = torch.zeros((num_s, pf.num_particles), dtype=torch.float32, device=dev)
    ests, records = [], []
    for t, zs in zip(_times(observations.shape[1], dev), observations.T):
        step = trandom.split(ks)
        ks = step[:, 0]
        pr = trandom.split(step[:, 1])
        k_pred, k_res = pr[:, 0], pr[:, 1]
        x = _call(pf.model.transition, k_pred, particles, t, theta=thetas)
        w = _call(pf.model.likelihood, zs.unsqueeze(1), x, t, theta=thetas)
        if conditional:
            log_w = log_w + log_weights_from_linear(w)
            wn = normalise_log_weights(log_w)
            est = (wn * x).sum(dim=1) / wn.sum(dim=1)
            particles, _, stats = resampler.step_rows(k_res, log_w, x, pf.ess_threshold)
            fired = (stats.ess_norm < pf.ess_threshold).unsqueeze(1)
            log_w = torch.where(fired, torch.zeros_like(log_w), log_w)
        else:
            particles, ancestors = resampler.apply_rows(k_res, w, x)
            est = particles.mean(dim=1)
            stats = _alg6_step_stats(w, ancestors) if telemetry else None
        ests.append(est)
        records.append(stats)
    ests = torch.stack(ests, dim=1)
    if not telemetry:
        return ests
    return ests, Telemetry(steps=stack_stats(records, dim=1))


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_filter_timed(key, pf: ParticleFilter, observations, warmup: int = 2, device="cuda"):
    """Per-stage wall timing of the Alg. 6 filter for the Resample-Ratio
    metric (paper eq. 25): the card is synchronised at every stage boundary
    and the first ``warmup`` steps are excluded.  Returns ``(estimates
    f32[T] on the CPU, {"predict_update", "resample", "estimate"} seconds)``."""
    dev = resolve_device(device)
    model = pf.model
    observations = torch.as_tensor(observations, dtype=torch.float32).to(dev)
    k0, key = trandom.split(key)
    particles = model.init(k0, pf.num_particles, dev)
    times = {"predict_update": 0.0, "resample": 0.0, "estimate": 0.0}
    ests = []
    for i, (t, z) in enumerate(zip(_times(observations.shape[0], dev), observations)):
        key, k1, k2 = trandom.split(key, 3)
        _sync(dev)
        t0 = time.perf_counter()
        x = model.transition(k1, particles, t)
        w = model.likelihood(z, x, t)
        _sync(dev)
        t1 = time.perf_counter()
        particles, _ = pf._built.apply(k2, w, x)
        _sync(dev)
        t2 = time.perf_counter()
        est = particles.mean()
        _sync(dev)
        t3 = time.perf_counter()
        if i >= warmup:
            times["predict_update"] += t1 - t0
            times["resample"] += t2 - t1
            times["estimate"] += t3 - t2
        ests.append(float(est))
    return torch.tensor(ests), times
