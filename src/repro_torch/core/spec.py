"""Typed resampler specs, the built resampler and the name registry, after
``repro.core.spec`` (the Megopolis and Metropolis families, Metropolis-C1
and -C2, Murray's rejection and the five prefix-sum kinds: every family of
the JAX package).

    spec = MegopolisSpec(num_iters=32)          # backend="cuda"
    spec = RejectionSpec(max_iters=1024)        # no num_iters: a capped loop
    spec = PrefixSumSpec(kind="multinomial")    # no num_iters: one scan, one search
    spec = MegopolisSpec(plane_dtype="bfloat16")  # 2-byte planes (every family)
    spec = MegopolisSpec(segment=32, backend="reference")  # the algorithm oracle
    spec = MetropolisSpec(guard="recover")      # degenerate rows resample uniformly
    spec = spec_from_name("metropolis_c1", num_iters=16)
    r = spec.build()
    ancestors = r(key, weights)
    particles2, ancestors = r.apply(key, weights, particles)
    particles2, ancestors, stats = r.step(key, log_w, particles, 0.5)

Backends: ``"cuda"`` (the default) runs the hand-written kernels, ``"reference"``
the reference algorithms of ``core/resamplers`` in plain torch ops, on JAX's
random streams, bit for bit with the JAX package's ``backend="reference"``
(the oracle the kernels are not: Megopolis at any ``segment``, C1/C2 at any
``partition_size_bytes``).  The JAX package's other backends are its ways of
compiling: ``"xla"`` (the reference, jitted) raises naming ``"reference"``,
``"pallas_interpret"`` and ``"pallas"`` raise naming ``"cuda"``.

The entries follow their inputs' device: CUDA tensors launch the
hand-written kernels (``cuda``) or run the reference's torch ops on the card
(``reference``), CPU tensors run the kernels' plain versions or the
reference on the CPU.  Keys are ``int64[2]`` (banks ``[S, 2]``) threefry key
data (``repro_torch.random``).

The registry (``spec_from_name``, ``spec_for_backend``, ``coerce_spec``,
``list_resamplers``, ``get_resampler``, ``get_resampler_batch``) maps the ten
family names onto specs and reference functions, with the JAX package's
semantics; ``launch_budget`` and ``contract_cells`` are the contract
checks' view of it.
"""

from __future__ import annotations

import dataclasses
import difflib
from typing import Any, Callable, ClassVar, Tuple, Union

import torch

from repro_torch import random as trandom
from repro_torch.core.iterations import select_iterations
from repro_torch.core.metrics import (
    degenerate_log_weights,
    degenerate_weights,
    effective_sample_size,
    log_mean_weight,
    max_normalised_weight,
    normalise_log_weights,
    unique_ancestor_count,
)
from repro_torch.core.resamplers import prefix_sum as _prefix_sum_module
from repro_torch.core.resamplers.batched import split_batch_keys
from repro_torch.core.resamplers.megopolis import DEFAULT_SEGMENT, megopolis, megopolis_batch
from repro_torch.core.resamplers.metropolis import (
    WARP,
    metropolis,
    metropolis_batch,
    metropolis_c1,
    metropolis_c1_batch,
    metropolis_c2,
    metropolis_c2_batch,
)
from repro_torch.core.resamplers.rejection import rejection, rejection_batch
from repro_torch.kernels.common import PLANE_DTYPES, compress_plane, quantise_plane
from repro_torch.kernels.megopolis import ops as mops
from repro_torch.kernels.metropolis import ops as tops
from repro_torch.kernels.prefix_sum import ops as pops
from repro_torch.kernels.rejection import ops as rops
from repro_torch.obs.stats import stats_from_vector
from repro_torch.obs.trace import dispatch_span
from repro_torch.resilience.fallback import build_with_fallback
from repro_torch.resilience.guards import check_guard_policy, maybe_emit_guard_event

AUTO = "auto"
#: The port's backends: the hand-written kernels and the reference algorithms.
BACKENDS = ("cuda", "reference")
#: The JAX package's ways of compiling, by the port's counterpart.
JAX_BACKENDS = {"xla": "reference", "pallas_interpret": "cuda", "pallas": "cuda"}
#: Kernel coalescing segment (the TPU's (8, 128) f32 tile, kept for parity).
KERNEL_SEGMENT = 1024
#: The C1/C2 kernels' partition: one segment of f32 weights.
KERNEL_PARTITION_BYTES = KERNEL_SEGMENT * 4
#: The reference backend's partition (the JAX package's default).
REFERENCE_PARTITION_BYTES = 128
#: The cap of eq. (3)'s B on the reference backend under 'auto'; Megopolis
#: draws its offset table at this size then, a stream of its own (the JAX
#: package's ``AUTO_MAX_ITERS``).
AUTO_MAX_ITERS = 4096


def _resolve_iters(num_iters, weights: torch.Tensor) -> int:
    """The iteration count: eq. (3) over concrete weights when 'auto'."""
    return select_iterations(weights) if num_iters == AUTO else num_iters


def _step_iters(num_iters, log_weights: torch.Tensor) -> int:
    """The step's iteration count: eq. (3) over the normalised weights the
    composed path hands to ``apply``, computed only under 'auto'."""
    if num_iters != AUTO:
        return num_iters
    return select_iterations(normalise_log_weights(log_weights.to(torch.float32)))


def _row_by_row(fn: Callable, split_key: bool) -> Callable:
    """A bank form that runs ``fn`` once per row (the JAX package's
    ``_per_row_auto_*``, and its ``vmap`` of the reference single call).
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
    """``batch_rows`` under 'auto' on ``cuda``: the JAX package maps the
    single kernel call over the rows (``jax.vmap``), which hands it traced
    weights, and its kernel path raises ``TypeError`` there; so does the
    port."""

    def batch_rows(keys, w):
        raise TypeError(
            f"{name}.batch_rows: num_iters='auto' needs each row's B before the launch "
            "(the JAX package's vmapped single call raises TypeError here); pass an int "
            "num_iters"
        )

    return batch_rows


def _reference_resampler(spec: "ResamplerSpec", single: Callable) -> "Resampler":
    """The reference backend's ``Resampler``: every entry composed from the
    single call, as the JAX base class composes its non-kernel backends
    (``batch`` and ``batch_rows`` over the rows' keys, ``apply`` the index
    call then the gather, ``step`` the normalise, ESS, branch and apply)."""
    plane_dtype = spec.plane_dtype

    def apply(key, w, p):
        anc = single(key, w)
        return p[anc.long()], anc

    def step(key, lw, p, thr):
        n = lw.shape[-1]
        ess_n = effective_sample_size(lw) / float(n)
        do = ess_n < torch.tensor(thr, dtype=torch.float32)
        # The normalised weights land on the plane grid (a no-op at f32).
        w = quantise_plane(normalise_log_weights(lw), plane_dtype)
        p_res, a_res = apply(key, w, p)
        ancestors = torch.where(do, a_res, torch.arange(n, dtype=torch.int32, device=lw.device))
        p_out = torch.where(do, p_res, p)
        incr = torch.where(do, log_mean_weight(lw), torch.zeros((), device=lw.device))
        stats4 = torch.stack([ess_n, incr, do.to(torch.float32), max_normalised_weight(lw)])
        return p_out, ancestors, stats4

    return Resampler(spec, single=single, batch=_row_by_row(single, True),
                     batch_rows=_row_by_row(single, False), apply=apply,
                     apply_batch=_row_by_row(apply, True),
                     apply_rows=_row_by_row(apply, False), step=step,
                     step_rows=_row_by_row(step, False))


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
    family's contract: for Metropolis, C1, C2 and rejection row ``s`` is the
    single call with ``split(key, S)[s]``, and so for the prefix-sum kinds;
    Megopolis's shares one offset table over the bank.  With a fixed
    iteration count (rejection and the prefix-sum kinds always) each bank
    form is one launch per stage.
    ``apply`` selects ancestors and copies their state in one launch, with
    the ancestors of ``__call__``.  ``step`` normalises, computes the ESS,
    resamples iff ``ess_norm < threshold`` (strict) and copies state in one
    launch; its resample branch equals ``apply(key, exp(lw - max lw),
    particles)``, its no-op branch returns the particles with identity
    ancestors and ``incr = 0``.  The key is consumed either way.

    Compressed planes (DESIGN.md §14, the spec's ``plane_dtype``): every
    entry narrows its float inputs, weights (or log-weights) and particles,
    once to the plane dtype (``compress_plane``: the values ``quantise``
    gives, in the word the kernels move), and the particles it returns have
    the caller's dtype again.  So ``r_bf16(key, w)`` equals ``r_f32(key,
    r_bf16.quantise(w))``; the step's sweep runs on its normalised weights
    requantised to the plane dtype, inside the kernel.  At float32 nothing
    is narrowed.  The reference backend quantises (float32 values on the
    plane grid, as the JAX package's reference does) and never narrows.

    The degeneracy guard (DESIGN.md §16, the spec's ``guard``) acts on the
    weights each entry dispatches, after the plane dtype: ``'recover'``
    replaces a degenerate row (total mass not a positive finite number; for
    the step, a non-finite max log-weight) by the uniform bank, ``1/N``
    weights or all-zero log-weights, with ``torch.where`` before the launch,
    so the kernels and their count of launches are those of ``'off'``;
    ``'flag'`` runs ``'off'``'s program and, while a recorder is active
    (``resilience.guards.record_resilience_events``), emits one
    ``guard_degenerate`` event per call that saw a collapsed row.
    """

    def __init__(self, spec: "ResamplerSpec", *, single: Callable, batch: Callable,
                 batch_rows: Callable, apply: Callable, apply_batch: Callable,
                 apply_rows: Callable, step: Callable, step_rows: Callable):
        self.spec = spec
        self.name = spec.name
        self.plane_dtype = spec.plane_dtype
        self.backend = spec.backend
        self.guard = spec.guard
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

    def quantise(self, x: torch.Tensor) -> torch.Tensor:
        """Round a float tensor onto the spec's plane-dtype grid, keeping
        its dtype (``quantise_plane``): the value the compressed planes
        carry.  ``x`` itself at float32 and for non-float tensors."""
        return quantise_plane(x, self.plane_dtype)

    def _span(self, entry: str):
        """The dispatch trace span (DESIGN.md §15,
        ``obs.trace.dispatch_span``): ``family/backend/entry/plane_dtype``,
        e.g. ``megopolis/cuda/step/float32``.  Identity unless tracing is
        enabled; it launches nothing either way."""
        return dispatch_span(self.name, self.backend, entry, self.plane_dtype)

    def _narrow(self, x: torch.Tensor) -> torch.Tensor:
        """An entry's float input in the plane dtype (none at float32); on
        the reference backend its values on the plane grid instead."""
        if self.plane_dtype == "float32":
            return x
        if self.backend == "reference":
            return self.quantise(x)
        return compress_plane(x, self.plane_dtype)

    @staticmethod
    def _widen(out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """Particles out in the caller's dtype."""
        return out if out.dtype == like.dtype else out.to(like.dtype)

    def _guard_weights(self, w: torch.Tensor, entry: str) -> torch.Tensor:
        """The guard of the linear-weight entries: at ``'recover'`` each
        degenerate row (``metrics.degenerate_weights``) becomes ``1/N``
        (bit for bit on clean rows); at ``'flag'`` ``w`` itself and, while a
        recorder is active, the event; at ``'off'`` ``w`` with no op."""
        if self.guard == "off":
            return w
        if self.guard == "recover":
            deg = degenerate_weights(w)
            w = torch.where(deg.unsqueeze(-1), torch.full_like(w, 1.0 / w.shape[-1]), w)
            maybe_emit_guard_event(self.name, self.backend, entry, self.guard, deg)
        else:
            maybe_emit_guard_event(self.name, self.backend, entry, self.guard,
                                   lambda: degenerate_weights(w))
        return w

    def _guard_log_weights(self, lw: torch.Tensor, entry: str):
        """The step's guard: ``(lw_run, degenerate)``.  ``degenerate``
        (``metrics.degenerate_log_weights``) goes into ``StepStats`` under
        every policy; at ``'recover'`` degenerate rows become all-zero
        log-weights (the uniform bank) before the launch, so the kernel
        runs a clean program with the same key and every output is finite."""
        deg = degenerate_log_weights(lw)
        if self.guard == "recover":
            lw = torch.where(deg.unsqueeze(-1), torch.zeros_like(lw), lw)
        if self.guard != "off":
            maybe_emit_guard_event(self.name, self.backend, entry, self.guard, deg)
        return lw, deg

    def _weights(self, weights: torch.Tensor, entry: str) -> torch.Tensor:
        return self._guard_weights(self._narrow(weights), entry)

    def __call__(self, key, weights):
        """Index-only resample of one population: ancestors ``int32[N]``."""
        self._check("__call__", weights, 1)
        with self._span("single"):
            return self._single(key, self._weights(weights, "single"))

    def batch(self, key, weights):
        """Index-only resample of a bank ``[S, N]`` under one key."""
        self._check("batch", weights, 2)
        with self._span("batch"):
            return self._batch(key, self._weights(weights, "batch"))

    def batch_rows(self, keys, weights):
        """Index-only resample of a bank over explicit per-row keys."""
        self._check("batch_rows", weights, 2, keys=keys)
        with self._span("batch_rows"):
            return self._batch_rows(keys, self._weights(weights, "batch_rows"))

    def _applied(self, fn, entry, key, weights, particles):
        with self._span(entry):
            p_out, anc = fn(key, self._weights(weights, entry), self._narrow(particles))
            return self._widen(p_out, particles), anc

    def apply(self, key, weights, particles):
        """Fused resample + gather of one population."""
        self._check("apply", weights, 1, particles)
        return self._applied(self._apply, "apply", key, weights, particles)

    def apply_batch(self, key, weights, particles):
        """Bank form of ``apply`` under one key."""
        self._check("apply_batch", weights, 2, particles)
        return self._applied(self._apply_batch, "apply_batch", key, weights, particles)

    def apply_rows(self, keys, weights, particles):
        """``apply`` over explicit per-row keys."""
        self._check("apply_rows", weights, 2, particles, keys)
        return self._applied(self._apply_rows, "apply_rows", keys, weights, particles)

    def _stepped(self, fn, entry, key, log_weights, particles, ess_threshold):
        with self._span(entry):
            lw, deg = self._guard_log_weights(self._narrow(log_weights), entry)
            p_out, anc, stats4 = fn(key, lw, self._narrow(particles), ess_threshold)
            stats = stats_from_vector(stats4, unique_ancestor_count(anc), deg)
            return self._widen(p_out, particles), anc, stats

    def step(self, key, log_weights, particles, ess_threshold: float):
        """Fused SMC step of one population: ``(particles', ancestors,
        StepStats)``."""
        self._check("step", log_weights, 1, particles)
        return self._stepped(self._step, "step", key, log_weights, particles, ess_threshold)

    def step_rows(self, keys, log_weights, particles, ess_threshold: float):
        """``step`` over explicit per-row keys, each row with its own
        decision; the ``StepStats`` fields are ``[S]``."""
        self._check("step_rows", log_weights, 2, particles, keys)
        return self._stepped(self._step_rows, "step_rows", keys, log_weights, particles,
                             ess_threshold)

    def __repr__(self):
        return f"Resampler({self.spec!r})"


@dataclasses.dataclass(frozen=True)
class ResamplerSpec:
    """Base class: a frozen spec of one resampler family on one of the
    port's backends.  Subclasses add their fields and ``build``."""

    name: ClassVar[str] = ""

    def _validate_num_iters(self):
        """The check of the families with an iteration count B."""
        it = self.num_iters
        if it != AUTO and (isinstance(it, bool) or not isinstance(it, int) or it < 1):
            raise ValueError(
                f"{type(self).__name__}.num_iters must be a positive int or {AUTO!r}; got {it!r}"
            )

    def _validate(self):
        """The checks every family shares: ``backend``, ``plane_dtype`` and
        ``guard``.  A JAX backend raises naming the port's counterpart."""
        cls = type(self).__name__
        if self.backend in JAX_BACKENDS:
            raise ValueError(
                f"{cls}.backend={self.backend!r} is a JAX way of compiling; the port's "
                f"counterpart is backend={JAX_BACKENDS[self.backend]!r} (one of {BACKENDS})"
            )
        if self.backend not in BACKENDS:
            raise ValueError(f"{cls}.backend must be one of {BACKENDS}; got {self.backend!r}")
        if self.plane_dtype not in PLANE_DTYPES:
            raise ValueError(f"{cls}.plane_dtype must be one of {PLANE_DTYPES}; got "
                             f"{self.plane_dtype!r}")
        check_guard_policy(self.guard, cls)

    def replace(self, **changes) -> "ResamplerSpec":
        """A validated copy with ``changes`` applied."""
        return dataclasses.replace(self, **changes)

    def build(self) -> Resampler:
        raise NotImplementedError

    def build_resilient(self, *, ladder=None, recorder=None, probe: bool = True,
                        device="cuda") -> Resampler:
        """Build with the backend fallback ladder (DESIGN.md §16): this
        spec's backend first, then each rung below it (``cuda`` →
        ``reference``) on a typed build or probe failure, one
        ``backend_demotion`` event per failed rung into ``recorder`` (and
        any active ``record_resilience_events``).  The probe resamples on
        ``device``.  Raises ``BackendUnavailable`` (with each rung's cause)
        only when every rung fails.  The one way to demote a backend:
        ``build()`` never does."""
        return build_with_fallback(self, ladder=ladder, recorder=recorder, probe=probe,
                                   device=device)


def _auto_single(it, fn):
    """The reference single call of the Metropolis family: B from eq. (3)
    capped at ``AUTO_MAX_ITERS`` under 'auto' (bit for bit with the same
    fixed B: B is only a loop bound and a ``fold_in`` counter)."""

    def single(key, w):
        b = min(select_iterations(w), AUTO_MAX_ITERS) if it == AUTO else it
        return fn(key, w, b)

    return single


@dataclasses.dataclass(frozen=True)
class MegopolisSpec(ResamplerSpec):
    """The paper's Megopolis resampler (Alg. 5).  On ``cuda`` the
    hand-written kernels, whose coalescing ``segment`` is fixed at 1024 as
    on the TPU, so that the two agree bit for bit; on ``reference`` the
    algorithm at any ``segment`` (the paper's warp is 32).

    'auto' resolves eq. (3) per call.  On ``cuda`` ``batch``/``apply_batch``
    resolve one B for the whole bank (one shared offset table), ``apply_rows``
    and ``step_rows`` launch row by row; on ``reference`` every bank row is
    its own single call, whose offsets are drawn at ``AUTO_MAX_ITERS``
    (a stream of its own, as in the JAX package)."""

    num_iters: Union[int, str] = AUTO
    segment: int = KERNEL_SEGMENT
    backend: str = "cuda"
    plane_dtype: str = "float32"
    guard: str = "off"

    name: ClassVar[str] = "megopolis"

    def __post_init__(self):
        self._validate_num_iters()
        self._validate()
        seg = self.segment
        if isinstance(seg, bool) or not isinstance(seg, int) or seg < 1:
            raise ValueError(f"MegopolisSpec.segment must be a positive int; got {seg!r}")
        if self.backend == "cuda" and seg != KERNEL_SEGMENT:
            raise ValueError(
                f"MegopolisSpec: the cuda kernels coalesce at segment={KERNEL_SEGMENT}; "
                f"got segment={seg!r}. Set segment={KERNEL_SEGMENT} or use "
                "backend='reference'."
            )

    def _reference(self) -> Resampler:
        it, seg = self.num_iters, self.segment

        def single(key, w):
            if it != AUTO:
                return megopolis(key, w, it, segment=seg)
            b = min(select_iterations(w), AUTO_MAX_ITERS)
            key_off, _ = trandom.split(key)
            offsets = trandom.randint(key_off, (AUTO_MAX_ITERS,), 0, w.shape[0])
            return megopolis(key, w, b, segment=seg, offsets=offsets)

        return _reference_resampler(self, single)

    def build(self) -> Resampler:
        if self.backend == "reference":
            return self._reference()
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
            return mops.megopolis_cuda_step(key, lw, p, _step_iters(it, lw), thr)

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


def _split_key_build(spec: "ResamplerSpec", prefix: str) -> Resampler:
    """The build of the Metropolis family (Algs. 2-4), whose bank rows are
    the single calls with ``split(key, S)[s]`` or ``keys[s]``: the entries
    are ``kernels/metropolis/ops.py``'s ``<prefix>``, ``<prefix>_batch``,
    ... ``<prefix>_step_rows``.  'auto' resolves eq. (3) per call, and every
    bank form launches row by row so that each row gets its own B."""
    it = spec.num_iters
    entry = {suffix: getattr(tops, prefix + suffix) for suffix in (
        "", "_batch", "_batch_rows", "_apply", "_apply_batch", "_apply_rows", "_step",
        "_step_rows")}

    def single(key, w):
        return entry[""](key, w, _resolve_iters(it, w))

    def apply(key, w, p):
        return entry["_apply"](key, w, p, _resolve_iters(it, w))

    def step(key, lw, p, thr):
        return entry["_step"](key, lw, p, _step_iters(it, lw), thr)

    if it == AUTO:
        return Resampler(spec, single=single, batch=_row_by_row(single, True),
                         batch_rows=_auto_batch_rows(spec.name), apply=apply,
                         apply_batch=_row_by_row(apply, True),
                         apply_rows=_row_by_row(apply, False),
                         step=step, step_rows=_row_by_row(step, False))
    return Resampler(
        spec, single=single,
        batch=lambda key, w: entry["_batch"](key, w, it),
        batch_rows=lambda keys, w: entry["_batch_rows"](keys, w, it),
        apply=apply,
        apply_batch=lambda key, w, p: entry["_apply_batch"](key, w, p, it),
        apply_rows=lambda keys, w, p: entry["_apply_rows"](keys, w, p, it),
        step=step,
        step_rows=lambda keys, lw, p, thr: entry["_step_rows"](keys, lw, p, it, thr),
    )


@dataclasses.dataclass(frozen=True)
class MetropolisSpec(ResamplerSpec):
    """The paper's random-access Metropolis baseline (Alg. 2), on the
    hand-written CUDA kernels or the reference algorithm.

    'auto' resolves eq. (3) per call, and every bank form runs row by row
    so that each row gets its own B (``batch``/``apply_batch`` still under
    the split-key contract)."""

    num_iters: Union[int, str] = AUTO
    backend: str = "cuda"
    plane_dtype: str = "float32"
    guard: str = "off"

    name: ClassVar[str] = "metropolis"

    def __post_init__(self):
        self._validate_num_iters()
        self._validate()

    def build(self) -> Resampler:
        if self.backend == "reference":
            return _reference_resampler(self, _auto_single(self.num_iters, metropolis))
        return _split_key_build(self, "metropolis_cuda")


@dataclasses.dataclass(frozen=True)
class _PartitionedSpec(ResamplerSpec):
    """Base of the segment-local variants (Algs. 3-4): each proposal is a
    random lane of one partition shared by a warp of particles.  On
    ``cuda`` the partition is one tile of 1024 f32 shared by a tile of 1024
    particles, ``partition_size_bytes`` = 4096 at every ``plane_dtype``, as
    on the TPU, and ``warp`` is kept for parity and, as in the JAX
    package's kernels, not read by them; on ``reference`` any partition
    size and warp (the paper's: 128 bytes, 32 threads)."""

    num_iters: Union[int, str] = AUTO
    partition_size_bytes: int = KERNEL_PARTITION_BYTES
    warp: int = WARP
    backend: str = "cuda"
    plane_dtype: str = "float32"
    guard: str = "off"

    def __post_init__(self):
        cls = type(self).__name__
        self._validate_num_iters()
        self._validate()
        for field in ("partition_size_bytes", "warp"):
            value = getattr(self, field)
            if isinstance(value, bool) or not isinstance(value, int) or value < 1:
                raise ValueError(f"{cls}.{field} must be a positive int; got {value!r}")
        if self.backend == "cuda" and self.partition_size_bytes != KERNEL_PARTITION_BYTES:
            raise ValueError(
                f"{cls}: the cuda kernels' partition is one tile of {KERNEL_SEGMENT} f32 = "
                f"{KERNEL_PARTITION_BYTES} bytes; got partition_size_bytes="
                f"{self.partition_size_bytes}. Set partition_size_bytes="
                f"{KERNEL_PARTITION_BYTES}, or use backend='reference' for the paper's "
                "warp-granular partitions."
            )

    def _reference(self, fn) -> Resampler:
        psb, warp = self.partition_size_bytes, self.warp
        return _reference_resampler(self, _auto_single(
            self.num_iters,
            lambda key, w, b: fn(key, w, b, partition_size_bytes=psb, warp=warp)))


@dataclasses.dataclass(frozen=True)
class MetropolisC1Spec(_PartitionedSpec):
    """Paper Alg. 3 (Dülger's C1): one partition tile per tile of particles,
    kept for all B iterations."""

    name: ClassVar[str] = "metropolis_c1"

    def build(self) -> Resampler:
        if self.backend == "reference":
            return self._reference(metropolis_c1)
        return _split_key_build(self, "metropolis_c1_cuda")


@dataclasses.dataclass(frozen=True)
class MetropolisC2Spec(_PartitionedSpec):
    """Paper Alg. 4 (Dülger's C2): a fresh partition tile per tile of
    particles at every iteration."""

    name: ClassVar[str] = "metropolis_c2"

    def build(self) -> Resampler:
        if self.backend == "reference":
            return self._reference(metropolis_c2)
        return _split_key_build(self, "metropolis_c2_cuda")


@dataclasses.dataclass(frozen=True)
class RejectionSpec(ResamplerSpec):
    """Murray's rejection resampler (paper §1's unbiased baseline): each
    particle proposes until its first
    accept, at most ``max_iters`` rounds after its self-proposal; a
    particle that never accepts keeps its own index.  It has no iteration
    count B and so no 'auto'; ``step`` computes nothing on the host before
    its launch.  On ``cuda`` every bank form is one launch,
    ``batch``/``apply_batch`` under the split-key contract."""

    max_iters: int = 1024
    backend: str = "cuda"
    plane_dtype: str = "float32"
    guard: str = "off"

    name: ClassVar[str] = "rejection"

    def __post_init__(self):
        m = self.max_iters
        if isinstance(m, bool) or not isinstance(m, int) or m < 1:
            raise ValueError(f"RejectionSpec.max_iters must be a positive int; got {m!r}")
        self._validate()

    def build(self) -> Resampler:
        m = self.max_iters
        if self.backend == "reference":
            return _reference_resampler(
                self, lambda key, w: rejection(key, w, max_iters=m))
        return Resampler(
            self,
            single=lambda key, w: rops.rejection_cuda(key, w, m),
            batch=lambda key, w: rops.rejection_cuda_batch(key, w, m),
            batch_rows=lambda keys, w: rops.rejection_cuda_batch_rows(keys, w, m),
            apply=lambda key, w, p: rops.rejection_cuda_apply(key, w, p, m),
            apply_batch=lambda key, w, p: rops.rejection_cuda_apply_batch(key, w, p, m),
            apply_rows=lambda keys, w, p: rops.rejection_cuda_apply_rows(keys, w, p, m),
            step=lambda key, lw, p, thr: rops.rejection_cuda_step(key, lw, p, m, thr),
            step_rows=lambda keys, lw, p, thr: rops.rejection_cuda_step_rows(
                keys, lw, p, m, thr),
        )


@dataclasses.dataclass(frozen=True)
class PrefixSumSpec(ResamplerSpec):
    """The prefix-sum family (paper §6.5): ``kind`` one of multinomial (Alg.
    7), systematic and improved systematic (Alg. 8), stratified and
    residual, on the hand-written CUDA kernels (a block scan, a bisection,
    and the fused step) or the reference algorithms.  None takes an
    iteration count, so there is no 'auto'; the spec's ``name`` is its kind,
    as in the JAX package.  On ``cuda`` every bank form launches each stage
    once over the bank, ``batch``/``apply_batch`` under the split-key
    contract; ``residual`` takes N <= 2**24."""

    kind: str = "systematic"
    backend: str = "cuda"
    plane_dtype: str = "float32"
    guard: str = "off"

    def __post_init__(self):
        if self.kind not in pops.PREFIX_KINDS:
            hint = difflib.get_close_matches(str(self.kind), pops.PREFIX_KINDS, n=1)
            did_you_mean = f" — did you mean {hint[0]!r}?" if hint else ""
            raise ValueError(
                f"PrefixSumSpec.kind must be one of {sorted(pops.PREFIX_KINDS)}; "
                f"got {self.kind!r}{did_you_mean}"
            )
        self._validate()

    @property
    def name(self) -> str:
        return self.kind

    def build(self) -> Resampler:
        kind = self.kind
        if self.backend == "reference":
            return _reference_resampler(self, getattr(_prefix_sum_module, kind))
        return Resampler(
            self,
            single=lambda key, w: pops.prefix_resample_cuda(key, w, kind),
            batch=lambda key, w: pops.prefix_resample_cuda_batch(key, w, kind),
            batch_rows=lambda keys, w: pops.prefix_resample_cuda_batch_rows(keys, w, kind),
            apply=lambda key, w, p: pops.prefix_resample_cuda_apply(key, w, p, kind),
            apply_batch=lambda key, w, p: pops.prefix_resample_cuda_apply_batch(key, w, p, kind),
            apply_rows=lambda keys, w, p: pops.prefix_resample_cuda_apply_rows(keys, w, p, kind),
            step=lambda key, lw, p, thr: pops.prefix_resample_cuda_step(key, lw, p, thr, kind),
            step_rows=lambda keys, lw, p, thr: pops.prefix_resample_cuda_step_rows(
                keys, lw, p, thr, kind),
        )


# ---------------------------------------------------------------------------
# The name registry, after ``repro.core.spec``: one family table, from which
# everything name-keyed derives (``spec_from_name``, ``spec_for_backend``,
# ``coerce_spec``, ``list_resamplers``, ``get_resampler(_batch)``) and the
# contract checks' cells (``launch_budget``, ``contract_cells``).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Family:
    spec_cls: type
    spec_fixed: Tuple[Tuple[str, Any], ...]  # fields frozen into the name
    legacy_single: Callable
    legacy_batch: Callable


_FAMILIES = {
    "megopolis": _Family(MegopolisSpec, (), megopolis, megopolis_batch),
    "metropolis": _Family(MetropolisSpec, (), metropolis, metropolis_batch),
    "metropolis_c1": _Family(MetropolisC1Spec, (), metropolis_c1,
                             metropolis_c1_batch),
    "metropolis_c2": _Family(MetropolisC2Spec, (), metropolis_c2,
                             metropolis_c2_batch),
    "rejection": _Family(RejectionSpec, (), rejection, rejection_batch),
    **{kind: _Family(PrefixSumSpec, (("kind", kind),), getattr(_prefix_sum_module, kind),
                     getattr(_prefix_sum_module, f"{kind}_batch"))
       for kind in pops.PREFIX_KINDS},
}


def _unknown_name_error(name: str) -> KeyError:
    choices = sorted(_FAMILIES)
    hint = difflib.get_close_matches(str(name), choices, n=1)
    did_you_mean = f" — did you mean {hint[0]!r}?" if hint else ""
    return KeyError(f"unknown resampler {name!r}{did_you_mean}; choices: {choices}")


def _family(name: str) -> _Family:
    try:
        return _FAMILIES[name]
    except KeyError:
        raise _unknown_name_error(name) from None


def spec_from_name(name: str, **kwargs) -> ResamplerSpec:
    """The typed spec of a registry name: ``spec_from_name('megopolis',
    num_iters=24) == MegopolisSpec(num_iters=24)``.  A ``num_iters`` kwarg is
    tolerated (and dropped) on the families without one (rejection and the
    prefix-sum kinds); any other unknown kwarg raises ``TypeError``."""
    fam = _family(name)
    fields = {f.name for f in dataclasses.fields(fam.spec_cls)}
    if "num_iters" not in fields:
        kwargs.pop("num_iters", None)
    unknown = sorted(set(kwargs) - fields)
    if unknown:
        raise TypeError(
            f"{name}: unknown spec argument(s) {unknown}; "
            f"{fam.spec_cls.__name__} fields are {sorted(fields)}"
        )
    return fam.spec_cls(**dict(fam.spec_fixed), **kwargs)


def spec_for_backend(name: str, backend: str, *, num_iters: Union[int, str] = 16,
                     max_iters: int = 64, plane_dtype: str = "float32",
                     guard: str = "off") -> ResamplerSpec:
    """A legal spec of any (family, backend) cell: the kernels' tile-fixed
    geometry on ``cuda`` (``segment=1024``, ``partition_size_bytes=4096``),
    the paper's on ``reference`` (``segment=32``, 128-byte partitions), so
    that sweeps over family x backend need not re-encode the table."""
    fam = _family(name)
    cuda = backend == "cuda"
    common = {"backend": backend, "plane_dtype": plane_dtype, "guard": guard}
    if fam.spec_cls is MegopolisSpec:
        return MegopolisSpec(num_iters=num_iters,
                             segment=KERNEL_SEGMENT if cuda else DEFAULT_SEGMENT, **common)
    if fam.spec_cls in (MetropolisC1Spec, MetropolisC2Spec):
        return fam.spec_cls(
            num_iters=num_iters,
            partition_size_bytes=KERNEL_PARTITION_BYTES if cuda else REFERENCE_PARTITION_BYTES,
            **common)
    if fam.spec_cls is RejectionSpec:
        return RejectionSpec(max_iters=max_iters, **common)
    if fam.spec_cls is MetropolisSpec:
        return MetropolisSpec(num_iters=num_iters, **common)
    return PrefixSumSpec(kind=name, **common)


def coerce_spec(resampler: Union[str, ResamplerSpec], /, **defaults) -> ResamplerSpec:
    """``str | ResamplerSpec`` -> a spec, with ``defaults`` applied only
    where the family has the field (``coerce_spec(name_or_spec,
    num_iters=b, segment=s)`` configures the Metropolis family and leaves
    the prefix-sum kinds as they are)."""
    spec = spec_from_name(resampler) if isinstance(resampler, str) else resampler
    if not isinstance(spec, ResamplerSpec):
        raise TypeError(
            f"expected a registry name or ResamplerSpec; got {type(resampler).__name__}"
        )
    fields = {f.name for f in dataclasses.fields(spec)}
    applicable = {k: v for k, v in defaults.items() if k in fields}
    return spec.replace(**applicable) if applicable else spec


def list_resamplers() -> list:
    """The ten registry names, sorted."""
    return sorted(_FAMILIES)


def get_resampler(name: str) -> Callable:
    """Legacy lookup: the reference function ``fn(key, weights, num_iters,
    **kw) -> int32[N]`` (prefer ``spec_from_name(name, **kw).build()``)."""
    return _family(name).legacy_single


def get_resampler_batch(name: str) -> Callable:
    """Legacy bank lookup: ``fn(key, weights[B, N], num_iters, **kw) ->
    int32[B, N]``, rows under ``split(key, B)`` (prefer ``.build().batch``)."""
    return _family(name).legacy_batch


# ---------------------------------------------------------------------------
# Static contracts (DESIGN.md §13), after ``repro.core.spec``: the launch
# budget of each (family, backend, entry) cell, which the contract checks
# (``python -m repro_torch.analysis``) hold every cell to.  ``cuda`` takes
# the JAX package's ``pallas`` budgets; ``reference`` launches no kernel of
# the port.
# ---------------------------------------------------------------------------

#: Every entry point of a built ``Resampler``, audited per cell.
ENTRY_POINTS = ("call", "batch", "batch_rows", "apply", "apply_batch", "apply_rows", "step",
                "step_rows")

# Direct families (Megopolis, Metropolis, C1/C2, rejection) launch once per
# entry.  The prefix-sum kinds pay a scan before the search, except the
# fused step, one launch for every family (DESIGN.md §12); residual pays
# three scans and two searches (index only) or three scans and the select.
_DIRECT_BUDGET = {entry: 1 for entry in ENTRY_POINTS}
_PREFIX_BUDGET = {entry: 2 for entry in ENTRY_POINTS} | {"step": 1, "step_rows": 1}
_RESIDUAL_BUDGET = {"call": 5, "batch": 5, "batch_rows": 5, "apply": 4, "apply_batch": 4,
                    "apply_rows": 4, "step": 1, "step_rows": 1}
LAUNCH_BUDGETS = {
    "megopolis": _DIRECT_BUDGET,
    "metropolis": _DIRECT_BUDGET,
    "metropolis_c1": _DIRECT_BUDGET,
    "metropolis_c2": _DIRECT_BUDGET,
    "rejection": _DIRECT_BUDGET,
    "multinomial": _PREFIX_BUDGET,
    "systematic": _PREFIX_BUDGET,
    "improved_systematic": _PREFIX_BUDGET,
    "stratified": _PREFIX_BUDGET,
    "residual": _RESIDUAL_BUDGET,
}


def _check_entry(entry: str):
    if entry not in ENTRY_POINTS:
        raise KeyError(f"unknown entry point {entry!r}; choices: {ENTRY_POINTS}")


def _check_backend(backend: str):
    if backend not in BACKENDS:
        raise KeyError(f"unknown backend {backend!r}; choices: {BACKENDS}")


def launch_budget(name: str, backend: str, entry: str) -> int:
    """Declared most port kernel launches of one (family, backend, entry)
    cell: the JAX package's ``pallas`` budget on ``cuda``, 0 on
    ``reference``."""
    _check_entry(entry)
    _check_backend(backend)
    _family(name)
    return LAUNCH_BUDGETS[name][entry] if backend == "cuda" else 0


def contract_cells(families=None, backends=None, entries=None):
    """The audited (family, backend, entry) cells: every registered family
    (or ``families``) by every backend (or ``backends``) by every entry
    point (or ``entries``)."""
    for name in families if families is not None else list_resamplers():
        _family(name)
        for backend in backends if backends is not None else BACKENDS:
            _check_backend(backend)
            for entry in entries if entries is not None else ENTRY_POINTS:
                _check_entry(entry)
                yield name, backend, entry
