"""Adaptive SMC sampler, the paper's AIS workload, after
``repro.ais.sampler`` (DESIGN.md §10).

N particles anneal from a normalised base π0 to an unnormalised target γ
along the geometric path, with the classic reweight → (ESS-triggered)
resample → MCMC-move step per temperature.  The resampling stage is ANY
``ResamplerSpec`` on either backend: one fused ``Resampler.step`` per
temperature (``step_rows`` for a bank), with no host branch around it.
On the analytic targets of ``ais/targets.py`` the logZ estimate has a
ground truth, so resampler quality is scored.

  * ``run_smc_sampler``: one sampler, a Python loop over temperatures (JAX's
    ``lax.scan``).
  * ``run_smc_sampler_bank``: S independent samplers with an explicit
    scenario axis (JAX's ``vmap``); row ``b`` equals the single call with
    ``split(key, S)[b]`` and ``thetas[b]``, leaf for leaf (DESIGN.md §4).

Key chains follow the JAX sampler split for split and live on the CPU;
bulk draws land on the particles' device.  The loops never wait on the
card except where ``num_iters="auto"`` resolves eq. (3) (one ``.item()``
per step, as in the filter).

Device rule: these entries take ``device="cuda"`` and raise without a card
unless the caller passes ``device="cpu"``; the target must have been built
on the same device.
"""

from __future__ import annotations

import dataclasses
import difflib
from typing import Optional, Union

import torch

from repro_torch import random as trandom
from repro_torch import resolve_device
from repro_torch.ais.moves import MOVES, TARGET_ACCEPT, adapt_step_size
from repro_torch.ais.schedule import geometric_schedule, next_temperature
from repro_torch.ais.targets import Target
from repro_torch.core.metrics import log_mean_weight
from repro_torch.core.resamplers.batched import split_batch_keys
from repro_torch.core.spec import ResamplerSpec, coerce_spec
from repro_torch.obs.stats import stack_stats
from repro_torch.obs.telemetry import Telemetry

SCHEDULES = ("geometric", "adaptive")


def _check_choice(value, choices, field: str):
    if value not in choices:
        hint = difflib.get_close_matches(str(value), choices, n=1)
        did_you_mean = f" — did you mean {hint[0]!r}?" if hint else ""
        raise ValueError(
            f"SMCSamplerConfig.{field} must be one of {sorted(choices)}; "
            f"got {value!r}{did_you_mean}"
        )


@dataclasses.dataclass(frozen=True)
class SMCSamplerConfig:
    """Annealed-SMC configuration.  ``resampler`` accepts a registry name or
    a typed ``ResamplerSpec``; with a spec, ``num_iters`` below is not
    consulted.  ``schedule='adaptive'`` selects the next temperature by CESS
    bisection at each step (``ais/schedule.py``), with ``num_temps`` as the
    cap: once β saturates at 1 the remaining steps are pure rejuvenation at
    the target (Δβ = 0 contributes nothing to logZ)."""

    num_particles: int
    num_temps: int = 24
    schedule: str = "geometric"  # 'geometric' | 'adaptive'
    beta_min: float = 1e-2  # geometric ladder start
    target_cess: float = 0.9  # adaptive: conditional-ESS fraction per step
    resampler: Union[str, ResamplerSpec] = "megopolis"
    num_iters: Union[int, str] = 16  # B (paper eq. 3; fixed application prior)
    ess_threshold: float = 0.5  # resample when normalised ESS < threshold
    move: str = "rwm"  # 'rwm' | 'mala'
    num_move_steps: int = 2
    step_size: float = 0.5  # initial ε, adapted per temperature
    target_accept: Optional[float] = None  # None -> per-move optimal scaling
    adapt_rate: float = 0.5

    def __post_init__(self):
        _check_choice(self.schedule, SCHEDULES, "schedule")
        _check_choice(self.move, tuple(MOVES), "move")
        if self.num_temps < 1:
            raise ValueError(
                f"SMCSamplerConfig.num_temps must be >= 1; got {self.num_temps}"
            )
        if self.num_particles < 1:
            raise ValueError(
                f"SMCSamplerConfig.num_particles must be >= 1; got {self.num_particles}"
            )
        if self.num_move_steps < 1:
            raise ValueError(
                "SMCSamplerConfig.num_move_steps must be >= 1 (the rejuvenation "
                f"sweep is what keeps the anneal mixing); got {self.num_move_steps}"
            )
        if not 0.0 < self.ess_threshold <= 1.0:
            raise ValueError(
                "SMCSamplerConfig.ess_threshold must be in (0, 1]; "
                f"got {self.ess_threshold}"
            )
        if not 0.0 < self.target_cess < 1.0:
            raise ValueError(
                "SMCSamplerConfig.target_cess must be in (0, 1); "
                f"got {self.target_cess}"
            )

    def resampler_spec(self) -> ResamplerSpec:
        if isinstance(self.resampler, ResamplerSpec):
            return self.resampler
        return coerce_spec(self.resampler, num_iters=self.num_iters)

    def resolved_target_accept(self) -> float:
        return (
            TARGET_ACCEPT[self.move]
            if self.target_accept is None
            else self.target_accept
        )


def _call(fn, *args, theta=None):
    """Invoke a target callable, appending ``theta`` only when given (the
    pf/filter.py scenario idiom)."""
    return fn(*args) if theta is None else fn(*args, theta)


def _logz_increment(log_w: torch.Tensor) -> torch.Tensor:
    """log( (1/N) Σ exp(log_w) ) over the particle axis: the normalising
    constant absorbed at the end.  The shared ``core.metrics.log_mean_weight``,
    the arithmetic the fused step kernels run for the in-loop increments.
    A bank reduces row by row, so that each row's sum is the single call's."""
    if log_w.dim() == 1:
        return log_mean_weight(log_w)
    return torch.stack([log_mean_weight(row) for row in log_w])


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def _result(x, log_w, log_z, betas, ess, accepts, n_res, records, telemetry, dim: int):
    """The JAX result dict (per-temperature leaves along ``dim``), and the
    ``Telemetry`` when asked for."""
    betas, ess, accepts = (torch.stack(v, dim=dim) for v in (betas, ess, accepts))
    result = {
        "particles": x,
        "log_w": log_w,
        "log_z": log_z + _logz_increment(log_w),
        "betas": betas,
        "ess": ess,
        "accept": accepts,
        "num_resamples": n_res,
    }
    if telemetry:
        return result, Telemetry(steps=stack_stats(records, dim=dim), accept=accepts,
                                 betas=betas)
    return result


def _halves(key):
    """``split(key)`` of a key ``[2]`` or a key bank ``[S, 2]``, row by row."""
    pair = trandom.split(key)
    return pair[..., 0, :], pair[..., 1, :]


def _anneal(who: str, keys, target: Target, cfg: SMCSamplerConfig, theta, telemetry: bool,
            device, lead: tuple, checkpoint=None):
    """The annealing loop of one sampler (``lead = ()``, a key ``[2]``) or of
    a bank (``lead = (S,)``, keys ``[S, 2]``, theta leaves ``[S, ...]``):
    the same ops on every row, so a bank row is its single call; the one
    difference is the resampler entry, ``step`` or ``step_rows``.  The
    checks run before any work."""
    if checkpoint is not None:
        raise NotImplementedError(
            f"{who}(checkpoint=...) is not ported yet (ROADMAP Queue A, item 7)"
        )
    dev = resolve_device(device)
    if not _same_device(torch.device(target.device), dev):
        raise ValueError(
            f"{who}: target {target.name!r} was built on {target.device}, the run is on "
            f"{dev}; build it with device={str(dev)!r}"
        )
    if lead:
        theta = _bank_thetas(theta, lead[0], dev)
    betas_in = (  # JAX's scan input: zeros under 'adaptive'
        torch.zeros(cfg.num_temps, dtype=torch.float32, device=dev)
        if cfg.schedule == "adaptive"
        else geometric_schedule(cfg.num_temps, cfg.beta_min, device=dev)
    )
    resampler = cfg.resampler_spec().build()
    n = cfg.num_particles
    move = MOVES[cfg.move]
    target_accept = cfg.resolved_target_accept()
    adaptive = cfg.schedule == "adaptive"
    step = resampler.step_rows if lead else resampler.step
    betas, ess_hist, accepts, records = [], [], [], []
    with torch.no_grad():
        k0, k = _halves(keys)
        x = _call(target.sample_base, k0, n, theta=theta)
        log_w = torch.zeros(lead + (n,), dtype=torch.float32, device=dev)
        log_z = torch.zeros(lead, dtype=torch.float32, device=dev)
        beta_prev = torch.zeros(lead, dtype=torch.float32, device=dev)
        step_size = torch.full(lead, cfg.step_size, dtype=torch.float32, device=dev)
        n_res = torch.zeros(lead, dtype=torch.int32, device=dev)
        for beta_in in betas_in:
            k, ks = _halves(k)
            k_res, k_move = _halves(ks)
            # 1. reweight: the geometric-path tilt at the current particles;
            #    under 'adaptive' a bank row's bisection holds once its bracket
            #    has converged, as JAX's batched while_loop does
            delta = (_call(target.log_target, x, theta=theta)
                     - _call(target.log_base, x, theta=theta))
            if adaptive:
                beta = next_temperature(log_w, delta, beta_prev, cfg.target_cess)
            else:
                beta = beta_in.expand(lead)
            log_w = log_w + (beta - beta_prev).unsqueeze(-1) * delta
            # 2. the fused step (one launch; a bank's rows each take their own
            #    branch): normalise, ESS, branch, resample + gather, increment
            x, _, stats = step(k_res, log_w, x, cfg.ess_threshold)
            did = stats.ess_norm < cfg.ess_threshold
            log_z = log_z + stats.log_evidence_incr
            log_w = torch.where(did.unsqueeze(-1), torch.zeros_like(log_w), log_w)

            # 3. rejuvenate against π_β, then adapt the step size
            def log_prob(y, b=beta.unsqueeze(-1)):
                return ((1.0 - b) * _call(target.log_base, y, theta=theta)
                        + b * _call(target.log_target, y, theta=theta))

            x, accept = move(k_move, x, log_prob, step_size, cfg.num_move_steps)
            step_size = adapt_step_size(step_size, accept, target_accept, cfg.adapt_rate)
            n_res = n_res + did.to(torch.int32)
            beta_prev = beta
            betas.append(beta)
            ess_hist.append(stats.ess_norm)
            accepts.append(accept)
            if telemetry:
                records.append(stats)
        return _result(x, log_w, log_z, betas, ess_hist, accepts, n_res, records,
                       telemetry, dim=len(lead))


def run_smc_sampler(key, target: Target, cfg: SMCSamplerConfig, theta=None,
                    telemetry: bool = False, checkpoint=None, device="cuda"):
    """Anneal π0 → γ; returns a dict:

    * ``particles`` f32[N, d], the final-temperature particle system;
    * ``log_w`` f32[N], the residual (since-last-resample) log-weights;
    * ``log_z`` f32[], the logZ = log ∫γ estimate;
    * ``betas`` / ``ess`` / ``accept`` f32[T], the per-temperature schedule,
      normalised pre-resampling ESS and move acceptance;
    * ``num_resamples`` i32[].

    ``telemetry=True`` returns ``(result, Telemetry)`` instead:
    ``Telemetry.steps`` holds the per-temperature ``StepStats`` (fields
    ``[T]``), ``accept`` and ``betas`` the dict's; the values are the ones
    the loop computes anyway, so the flag adds no launch and leaves the
    result bit-identical.  ``theta`` selects a scenario of a theta-family
    target.  ``checkpoint=`` is not ported (ROADMAP Queue A, item 7)."""
    return _anneal("run_smc_sampler", key, target, cfg, theta, telemetry, device, (),
                   checkpoint)


def _bank_thetas(thetas, num_s: int, dev):
    """Per-scenario leaves ``[S, ...]`` laid out for the bank's callables:
    ``[S, 1, ...]`` on the run's device (``[S]`` -> ``[S, 1]``, ``[S, d]`` ->
    ``[S, 1, d]``)."""
    if thetas is None:
        return None
    leaves = {name: torch.as_tensor(v, dtype=torch.float32).to(dev)
              for name, v in thetas.items()}
    return {name: v.reshape((num_s, 1) + tuple(v.shape[1:])) for name, v in leaves.items()}


def run_smc_sampler_bank(key, target: Target, cfg: SMCSamplerConfig, thetas=None,
                         num_scenarios: Optional[int] = None, telemetry: bool = False,
                         device="cuda"):
    """S independent samplers with one bank launch per temperature (the §4
    scenario axis).

    ``thetas`` is a dict whose leaves carry a leading [S] axis of
    per-scenario target parameters (see ``targets.gaussian_theta``); pass
    ``num_scenarios`` instead for S i.i.d. repeats of a fixed target.  The
    key splits once along the scenario axis and resampling is ONE
    ``Resampler.step_rows`` per temperature, so row ``b`` of every output
    equals ``run_smc_sampler(split(key, S)[b], target, cfg,
    theta=thetas[b])``.  Returns the ``run_smc_sampler`` dict with a leading
    [S] axis on every leaf; ``telemetry=True`` returns ``(result,
    Telemetry)`` with every trajectory field laid out ``[S, T]``."""
    if thetas is None and num_scenarios is None:
        raise ValueError(
            "run_smc_sampler_bank: pass per-scenario `thetas` (leading [S] "
            "leaves) or `num_scenarios` for i.i.d. repeats"
        )
    if thetas is not None:
        num_s = next(iter(thetas.values())).shape[0]
        if num_scenarios is not None and num_scenarios != num_s:
            raise ValueError(
                f"run_smc_sampler_bank: num_scenarios={num_scenarios} disagrees "
                f"with the thetas leading axis [{num_s}]"
            )
    else:
        num_s = num_scenarios
    return _anneal("run_smc_sampler_bank", split_batch_keys(key, num_s), target, cfg, thetas,
                   telemetry, device, (num_s,))
