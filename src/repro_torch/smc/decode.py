"""SMC / particle LM decoding, after ``repro.smc.decode``: the paper's
resampler as a serving feature (DESIGN.md §5).

Particles are concurrent decode hypotheses on the batch axis; weights come
from the proposal/target likelihood ratio (or a user twist function);
resampling prunes and duplicates hypotheses.  Resampling is any registered
family, Megopolis by default, over the particle axis, followed by an
ancestor gather of every KV-cache leaf.

  * weights need not be normalised (the Metropolis family uses only
    ratios): the loop keeps log-weights, and the step shifts by their max;
  * resampling is ESS-triggered, and the per-step reweight, ESS and
    conditional resample are ONE fused ``Resampler.step`` call (DESIGN.md
    §12): on ``cuda`` one launch of the family's step kernel a token, which
    also copies the int32 token buffer ``[N, T]`` as its state;
  * the KV-cache gather by the returned ancestors is plain PyTorch
    (``index_select`` of every leaf, every step, as the JAX package's
    ``jnp.take``): it is not a kernel of the JAX package either.

The JAX package runs the steps as one ``lax.scan``; the port runs them as a
Python loop over ``split(key, T)``, the same keys in the same order.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional, Union

import torch

from repro_torch import random as trandom
from repro_torch.core.metrics import effective_sample_size
from repro_torch.core.spec import KERNEL_SEGMENT, ResamplerSpec, coerce_spec
from repro_torch.models import ModelConfig, decode_step
from repro_torch.obs.stats import stack_stats
from repro_torch.obs.telemetry import Telemetry


@dataclasses.dataclass(frozen=True)
class SMCDecodeConfig:
    """``resampler`` accepts a registry name or a typed ``ResamplerSpec``
    (DESIGN.md §9).  A name resolves as the particle filter resolves one
    (``coerce_spec(name, num_iters=..., segment=...)``, each only where the
    family has the field): to the hand-written kernels on ``cuda``, whose
    Megopolis segment is the kernels' 1024 (``segment``'s default here).
    So a name on the port means the kernels, not the JAX package's
    reference at segment 32; ``num_particles`` must then be a multiple of
    1024.  A spec is used as it is, on either backend
    (``spec_for_backend(name, "reference")`` for the paper's segment 32)."""

    num_particles: int
    max_new_tokens: int
    resampler: Union[str, ResamplerSpec] = "megopolis"
    num_iters: int = 16  # B (paper eq. 3; fixed application prior, §7)
    ess_threshold: float = 0.5  # resample when ESS < threshold * N
    proposal_temp: float = 1.0
    target_temp: float = 0.7  # weights tilt samples toward the sharper target
    segment: int = KERNEL_SEGMENT  # Megopolis coalescing segment (the kernels')

    def resampler_spec(self) -> ResamplerSpec:
        if isinstance(self.resampler, ResamplerSpec):
            return self.resampler
        return coerce_spec(self.resampler, num_iters=self.num_iters, segment=self.segment)


# The module's public name for the shared ``core.metrics`` helper.
ess = effective_sample_size


def _scaled(logits: torch.Tensor, temp: float) -> torch.Tensor:
    """``logits / temp`` as a float32 division (a division by a Python
    scalar is a multiply by its reciprocal on the card)."""
    return logits / torch.tensor(temp, dtype=torch.float32, device=logits.device)


def _log_softmax_at(x: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(log_softmax(x), token)`` in ``jax.nn.log_softmax``'s
    terms (``shifted - log(sum(exp(shifted)))``), formed at the taken
    entries only."""
    shifted = x - x.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    return shifted.gather(-1, token[:, None].long())[:, 0] - lse


def _default_twist(logits: torch.Tensor, token: torch.Tensor, cfg: SMCDecodeConfig):
    """log-weight increment = log target(token) - log proposal(token).

    Proposal samples at ``proposal_temp``; the target density is the model
    at ``target_temp``: tempered-SMC decoding."""
    lp = _log_softmax_at(_scaled(logits, cfg.proposal_temp), token)
    lt = _log_softmax_at(_scaled(logits, cfg.target_temp), token)
    return lt - lp


def _gather(tree, ancestors: torch.Tensor):
    """Every tensor leaf of a cache tree indexed by ``ancestors`` on axis 0."""
    if isinstance(tree, dict):
        return {k: _gather(v, ancestors) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_gather(v, ancestors) for v in tree)
    return tree.index_select(0, ancestors)


def smc_decode(
    params,
    model_cfg: ModelConfig,
    smc_cfg: SMCDecodeConfig,
    caches,
    first_tokens: torch.Tensor,  # (N,) int32, the last prompt token per particle
    start_pos: int,  # position of first_tokens
    key: torch.Tensor,
    twist: Optional[Callable] = None,
    telemetry: bool = False,
):
    """Returns ``(tokens int32[N, T], log_weights f32[N], stats)`` with
    ``stats = {"ess_history": f32[T], "num_resamples": int32[]}``.

    ``caches`` must be prefilled for ``start_pos`` (``models.prefill``);
    particle i's hypothesis extends ``first_tokens[i]``.  The first step
    writes its K/V into ``caches`` in place (``models.decode_step``); every
    later step works on the gathered copies.

    ``telemetry=True`` (DESIGN.md §15) returns ``(tokens, log_weights,
    stats, Telemetry)`` with ``Telemetry.steps`` one ``StepStats`` per
    generated token (fields ``[T]``), values the loop computes anyway: no
    launch is added and the first three outputs are unchanged.
    """
    n, steps = smc_cfg.num_particles, smc_cfg.max_new_tokens
    twist_fn = twist or partial(_default_twist, cfg=smc_cfg)
    resampler = smc_cfg.resampler_spec().build()
    dev = first_tokens.device
    thr = smc_cfg.ess_threshold

    out_buf = torch.zeros((n, steps), dtype=torch.int32, device=dev)
    log_w = torch.zeros((n,), dtype=torch.float32, device=dev)
    n_resamples = torch.zeros((), dtype=torch.int32, device=dev)
    tokens_prev, pos = first_tokens, int(start_pos)
    ess_history, records = [], []
    for step_key in trandom.split(key, steps):
        k_samp, k_res = trandom.split(step_key)
        logits, caches = decode_step(params, model_cfg, tokens_prev[:, None], caches, pos)
        logits = logits.to(torch.float32)
        next_tok = trandom.categorical(k_samp, _scaled(logits, smc_cfg.proposal_temp))
        next_tok = next_tok.to(torch.int32)
        log_w = log_w + twist_fn(logits, next_tok)
        out_buf[:, pos - int(start_pos)] = next_tok
        # The fused step: normalise, ESS, the branch and the token-buffer
        # copy in one launch; its ancestors are the identity where the
        # branch did not fire, so the gather is then a copy.
        out_buf, ancestors, step_stats = resampler.step(k_res, log_w, out_buf, thr)
        trigger = step_stats.ess_norm < thr
        caches = _gather(caches, ancestors)
        log_w = torch.where(trigger, torch.zeros_like(log_w), log_w)
        n_resamples = n_resamples + trigger.to(torch.int32)
        ess_history.append(ess(log_w))
        if telemetry:
            records.append(step_stats)
        tokens_prev, pos = next_tok, pos + 1
    stats = {"ess_history": torch.stack(ess_history), "num_resamples": n_resamples}
    if telemetry:
        return out_buf, log_w, stats, Telemetry(steps=stack_stats(records, dim=0))
    return out_buf, log_w, stats
