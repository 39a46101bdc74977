"""Typed resampler specs and the built resampler, after ``repro.core.spec``
(the Megopolis and Metropolis families, Metropolis-C1 and -C2, Murray's
rejection and the five prefix-sum kinds: every family of the JAX package).

    spec = MegopolisSpec(num_iters=32)          # backend="cuda"
    spec = RejectionSpec(max_iters=1024)        # no num_iters: a capped loop
    spec = PrefixSumSpec(kind="multinomial")    # no num_iters: one scan, one search
    spec = MegopolisSpec(plane_dtype="bfloat16")  # 2-byte planes (every family)
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
import difflib
from typing import Callable, ClassVar, Union

import torch

from repro_torch.core.iterations import select_iterations
from repro_torch.core.metrics import (
    degenerate_log_weights,
    normalise_log_weights,
    unique_ancestor_count,
)
from repro_torch.core.resamplers.batched import split_batch_keys
from repro_torch.kernels.common import PLANE_DTYPES, compress_plane, quantise_plane
from repro_torch.kernels.megopolis import ops as mops
from repro_torch.kernels.metropolis import ops as tops
from repro_torch.kernels.prefix_sum import ops as pops
from repro_torch.kernels.rejection import ops as rops
from repro_torch.obs.stats import stats_from_vector

AUTO = "auto"
BACKENDS = ("cuda",)
#: The JAX package's backends that have no port yet.
_UNPORTED_BACKENDS = ("reference", "xla", "pallas_interpret", "pallas")
#: Kernel coalescing segment (the TPU's (8, 128) f32 tile, kept for parity).
KERNEL_SEGMENT = 1024
#: The C1/C2 kernels' partition: one segment of f32 weights.
KERNEL_PARTITION_BYTES = KERNEL_SEGMENT * 4
#: Threads per warp in the paper's cost model of C1/C2 (``warp`` field).
WARP = 32


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
    is narrowed.
    """

    def __init__(self, spec: "ResamplerSpec", *, single: Callable, batch: Callable,
                 batch_rows: Callable, apply: Callable, apply_batch: Callable,
                 apply_rows: Callable, step: Callable, step_rows: Callable):
        self.spec = spec
        self.name = spec.name
        self.plane_dtype = spec.plane_dtype
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

    def _narrow(self, x: torch.Tensor) -> torch.Tensor:
        """An entry's float input in the plane dtype (none at float32)."""
        return x if self.plane_dtype == "float32" else compress_plane(x, self.plane_dtype)

    @staticmethod
    def _widen(out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """Particles out in the caller's dtype."""
        return out if out.dtype == like.dtype else out.to(like.dtype)

    def __call__(self, key, weights):
        """Index-only resample of one population: ancestors ``int32[N]``."""
        self._check("__call__", weights, 1)
        return self._single(key, self._narrow(weights))

    def batch(self, key, weights):
        """Index-only resample of a bank ``[S, N]`` under one key."""
        self._check("batch", weights, 2)
        return self._batch(key, self._narrow(weights))

    def batch_rows(self, keys, weights):
        """Index-only resample of a bank over explicit per-row keys."""
        self._check("batch_rows", weights, 2, keys=keys)
        return self._batch_rows(keys, self._narrow(weights))

    def _applied(self, fn, key, weights, particles):
        p_out, anc = fn(key, self._narrow(weights), self._narrow(particles))
        return self._widen(p_out, particles), anc

    def apply(self, key, weights, particles):
        """Fused resample + gather of one population."""
        self._check("apply", weights, 1, particles)
        return self._applied(self._apply, key, weights, particles)

    def apply_batch(self, key, weights, particles):
        """Bank form of ``apply`` under one key."""
        self._check("apply_batch", weights, 2, particles)
        return self._applied(self._apply_batch, key, weights, particles)

    def apply_rows(self, keys, weights, particles):
        """``apply`` over explicit per-row keys."""
        self._check("apply_rows", weights, 2, particles, keys)
        return self._applied(self._apply_rows, keys, weights, particles)

    def _stepped(self, fn, key, log_weights, particles, ess_threshold):
        lw = self._narrow(log_weights)
        p_out, anc, stats4 = fn(key, lw, self._narrow(particles), ess_threshold)
        stats = stats_from_vector(stats4, unique_ancestor_count(anc),
                                  degenerate_log_weights(lw))
        return self._widen(p_out, particles), anc, stats

    def step(self, key, log_weights, particles, ess_threshold: float):
        """Fused SMC step of one population: ``(particles', ancestors,
        StepStats)``."""
        self._check("step", log_weights, 1, particles)
        return self._stepped(self._step, key, log_weights, particles, ess_threshold)

    def step_rows(self, keys, log_weights, particles, ess_threshold: float):
        """``step`` over explicit per-row keys, each row with its own
        decision; the ``StepStats`` fields are ``[S]``."""
        self._check("step_rows", log_weights, 2, particles, keys)
        return self._stepped(self._step_rows, keys, log_weights, particles, ess_threshold)

    def __repr__(self):
        return f"Resampler({self.spec!r})"


@dataclasses.dataclass(frozen=True)
class ResamplerSpec:
    """Base class: a frozen spec of one resampler family on the port's
    ``cuda`` backend.  Subclasses add their fields and ``build``."""

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
        ``guard``; values the port does not have yet raise
        ``NotImplementedError`` naming their ROADMAP item."""
        cls = type(self).__name__
        if self.backend in _UNPORTED_BACKENDS:
            raise NotImplementedError(
                f"{cls}.backend={self.backend!r} is not ported yet; the port "
                "runs backend='cuda' (ROADMAP Queue A, item 4: the reference backend)"
            )
        if self.backend not in BACKENDS:
            raise ValueError(f"{cls}.backend must be one of {BACKENDS}; got {self.backend!r}")
        if self.plane_dtype not in PLANE_DTYPES:
            raise ValueError(f"{cls}.plane_dtype must be one of {PLANE_DTYPES}; got "
                             f"{self.plane_dtype!r}")
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
        self._validate_num_iters()
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
        self._validate_num_iters()
        self._validate()

    def build(self) -> Resampler:
        return _split_key_build(self, "metropolis_cuda")


@dataclasses.dataclass(frozen=True)
class _PartitionedSpec(ResamplerSpec):
    """Base of the segment-local variants (Algs. 3-4): each proposal is a
    random lane of one partition tile shared by a tile of 1024 particles.
    On ``cuda`` the partition is that tile, ``partition_size_bytes`` =
    4096 (1024 f32) at every ``plane_dtype``, as on the TPU; ``warp`` (the
    threads that share a partition in the paper's cost model) is kept for
    parity and, as in the JAX package's kernels, not read by them."""

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
        if self.partition_size_bytes != KERNEL_PARTITION_BYTES:
            raise ValueError(
                f"{cls}: the cuda kernels' partition is one tile of {KERNEL_SEGMENT} f32 = "
                f"{KERNEL_PARTITION_BYTES} bytes; got partition_size_bytes="
                f"{self.partition_size_bytes}. Set partition_size_bytes="
                f"{KERNEL_PARTITION_BYTES}; the paper's warp-granular partitions belong to "
                "backend='reference' (ROADMAP Queue A, item 4)."
            )


@dataclasses.dataclass(frozen=True)
class MetropolisC1Spec(_PartitionedSpec):
    """Paper Alg. 3 (Dülger's C1): one partition tile per tile of particles,
    kept for all B iterations, on the hand-written CUDA kernels."""

    name: ClassVar[str] = "metropolis_c1"

    def build(self) -> Resampler:
        return _split_key_build(self, "metropolis_c1_cuda")


@dataclasses.dataclass(frozen=True)
class MetropolisC2Spec(_PartitionedSpec):
    """Paper Alg. 4 (Dülger's C2): a fresh partition tile per tile of
    particles at every iteration, on the hand-written CUDA kernels."""

    name: ClassVar[str] = "metropolis_c2"

    def build(self) -> Resampler:
        return _split_key_build(self, "metropolis_c2_cuda")


@dataclasses.dataclass(frozen=True)
class RejectionSpec(ResamplerSpec):
    """Murray's rejection resampler (paper §1's unbiased baseline) on the
    hand-written CUDA kernels: each particle proposes until its first
    accept, at most ``max_iters`` rounds after its self-proposal; a
    particle that never accepts keeps its own index.  It has no iteration
    count B and so no 'auto'; ``step`` computes nothing on the host before
    its launch.  Every bank form is one launch, ``batch``/``apply_batch``
    under the split-key contract."""

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
    and the fused step).  None takes an iteration count, so there is no
    'auto'; the spec's ``name`` is its kind, as in the JAX package.  Every
    bank form launches each stage once over the bank, ``batch``/
    ``apply_batch`` under the split-key contract; ``residual`` takes N <=
    2**24."""

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
# Static contracts (DESIGN.md §13), after ``repro.core.spec``: the families
# by name and the launch budget of each (family, entry) cell, which the
# contract checks (``python -m repro_torch.analysis``) hold every cell to.
# The port's one backend, ``cuda``, takes the JAX package's ``pallas``
# budgets.
# ---------------------------------------------------------------------------

#: Every entry point of a built ``Resampler``, audited per cell.
ENTRY_POINTS = ("call", "batch", "batch_rows", "apply", "apply_batch", "apply_rows", "step",
                "step_rows")

#: The ten families by name: ``(spec class, fixed fields)``.  The name
#: registry of ROADMAP Queue A item 4 (``spec_from_name``) takes it over.
FAMILIES = {
    "megopolis": (MegopolisSpec, {}),
    "metropolis": (MetropolisSpec, {}),
    "metropolis_c1": (MetropolisC1Spec, {}),
    "metropolis_c2": (MetropolisC2Spec, {}),
    "rejection": (RejectionSpec, {}),
    **{kind: (PrefixSumSpec, {"kind": kind}) for kind in pops.PREFIX_KINDS},
}

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


def family_names() -> list:
    """The family names, sorted."""
    return sorted(FAMILIES)


def _family(name: str):
    try:
        return FAMILIES[name]
    except KeyError:
        hint = difflib.get_close_matches(str(name), FAMILIES, n=1)
        did_you_mean = f" — did you mean {hint[0]!r}?" if hint else ""
        raise KeyError(f"unknown resampler family {name!r}{did_you_mean}; choices: "
                       f"{family_names()}") from None


def family_spec(name: str, **fields) -> ResamplerSpec:
    """The spec of family ``name`` with those of ``fields`` it has (so
    ``num_iters`` and ``max_iters`` may both be given for any family)."""
    cls, fixed = _family(name)
    own = {f.name for f in dataclasses.fields(cls)}
    return cls(**fixed, **{k: v for k, v in fields.items() if k in own})


def launch_budget(name: str, entry: str) -> int:
    """Declared most kernel launches of one (family, entry) cell."""
    if entry not in ENTRY_POINTS:
        raise KeyError(f"unknown entry point {entry!r}; choices: {ENTRY_POINTS}")
    _family(name)
    return LAUNCH_BUDGETS[name][entry]


def contract_cells(families=None, entries=None):
    """The audited (family, entry) cells: every family of ``FAMILIES`` (or
    ``families``) by every entry point (or ``entries``)."""
    for name in families if families is not None else family_names():
        _family(name)
        for entry in entries if entries is not None else ENTRY_POINTS:
            if entry not in ENTRY_POINTS:
                raise KeyError(f"unknown entry point {entry!r}; choices: {ENTRY_POINTS}")
            yield name, entry
