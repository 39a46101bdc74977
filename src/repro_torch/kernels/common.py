"""Shared kernel primitives, after ``repro.kernels.common``.

The counter-based hash RNG (murmur3 finalizer over ``(seed, particle,
iteration)``), ``key_to_seed``, the fused step's statistics prelude
``step_stats`` and its commit ``step_select`` — written once here in plain
PyTorch.  The plain versions of the CUDA kernels call them, and the CUDA
sources spell out the same arithmetic in ``common.cuh``, which both
``megopolis/csrc/megopolis.cu`` and ``metropolis/csrc/metropolis.cu``
include.  The checks every bank wrapper makes before a launch
(``check_bank``, ``check_launch``) live here too, the launch census
hook every wrapper carries (``kernel_wrapper``), and the plane-dtype axis
(``PLANE_DTYPES``, ``quantise_plane``, ``compress_plane``: DESIGN.md §14).

uint32 arithmetic runs in ``int64`` masked to 32 bits (torch's ``uint32``
has no ``+``, ``>>`` or ``%`` on the CPU); products are split into 16-bit
halves so that no ``int64`` product overflows.

Flush to zero: XLA on the CPU runs with subnormals flushed (FTZ/DAZ), and
the CUDA kernels are built with ``-ftz=true``.  The plain versions match
both by flushing explicitly (``flush_to_zero``) on the inputs and outputs of
the float arithmetic that selection depends on; state copies are bit moves
and are never flushed.  Process-wide ``torch.set_flush_denormal`` is not
used: it would change the numerics of everything else in the process.

The TPU's ``[d_pad, R, 128]`` plane layout and its VMEM residency caps do
not carry over: the port keeps state flat, ``[N, D]`` at the public API and
``[S, D, N]`` inside, with int32 particle indices (``N < 2**30``).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from repro_torch import random as trandom
from repro_torch.resilience.errors import KernelLaunchError

MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
LANES = 128
SUBLANES = 8
TILE = SUBLANES * LANES  # 1024 particles: the Megopolis coalescing segment
SEG = TILE
#: Largest particle count: int32 index arithmetic ``i + o + SEG`` and the
#: Metropolis accept lane ``i + N`` stay below 2**31.
MAX_PARTICLES = 1 << 30
#: Most rows of one bank launch: the kernels put the rows on grid.y.
MAX_ROWS = 65535
#: Rows of one step launch: the per-row shift and flags sit in shared memory.
MAX_STEP_ROWS = 4096
#: The plane-compression axis (DESIGN.md §14): the word the weight and
#: state planes move in.  The kernels upcast every load, so selection, the
#: hash, the uniforms and the step's statistics stay float32.
PLANE_DTYPES = ("float32", "bfloat16", "float16")
_FLT_MIN = torch.finfo(torch.float32).tiny
#: Integer state words a kernel that opts in (``check_bank``'s
#: ``int_state``) copies beside float32 weights, as the float32 instance's
#: words: a state copy is a bit move, never a float instruction, so every
#: bit pattern (token ids below 2**23 are float32 subnormals) comes back
#: as it went in.  Beside a 2-byte plane no instance copies a 4-byte word:
#: ROADMAP Queue C item 23.
INT_STATE_DTYPES = (torch.int32,)
INT_STATE_ITEM = "ROADMAP Queue C item 23"


def mul32(x, c: int):
    """``(x * c) mod 2**32`` for uint32 values in ``int64`` (or Python ints)
    without an ``int64`` overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & MASK32


def murmur3_fmix(x):
    """murmur3 32-bit finalizer; full-avalanche integer hash."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_bits(seed, lane_index, iteration: int):
    """uint32 stream indexed by (seed, particle, iteration):
    ``fmix(fmix(seed + b·GOLDEN) ^ (i·GOLDEN))`` as ``int64`` values."""
    s = (seed + iteration * _GOLDEN) & MASK32
    return murmur3_fmix(murmur3_fmix(s) ^ mul32(lane_index, _GOLDEN))


def hash_uniform(seed, lane_index, iteration: int) -> torch.Tensor:
    """U[0, 1) float32 with 24 bits of entropy: ``(bits >> 8)·2**-24``."""
    bits = hash_bits(seed, lane_index, iteration)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def key_to_seed(key: torch.Tensor) -> torch.Tensor:
    """uint32 hash seed of a key (``int64[..., 2]`` key data):
    ``fmix(k0 ^ k1·GOLDEN)``, returned as ``int64[...]``.  It consumes the
    key, as ``random_bits`` does: the observers of ``random.observe_keys``
    see it as ``"seed"``."""
    trandom.report_key("seed", key)
    return murmur3_fmix(key[..., 0] ^ mul32(key[..., 1], _GOLDEN))


def seed_bits(seeds: torch.Tensor) -> torch.Tensor:
    """uint32 seeds (``int64``) as the int32 bit patterns the CUDA kernels
    read as ``uint32_t``."""
    return torch.where(seeds >= 1 << 31, seeds - (1 << 32), seeds).to(torch.int32)


def tile_lane_ids(n: int, device) -> torch.Tensor:
    """Particle index of every lane, flat: the TPU's per-tile
    ``t·1024 + row·128 + col`` over all tiles is ``arange(N)``."""
    return torch.arange(n, dtype=torch.int32, device=device)


def megopolis_indices(i, offset, segment: int, n: int):
    """The comparison particle of lane ``i`` at offset ``o`` (paper Alg. 5
    lines 7-11): ``j = (aligned(i) + aligned(o) + (i + o) mod S) mod N``,
    vectorised over ``i``.  At ``segment=SEG`` it is the TPU's aligned tile
    fetch plus its ``flat_roll`` by ``o mod 1024``, in flat form; for a fixed
    ``o`` it is a segment-aligned rotation, a bijection of ``[0, N)``."""
    i_aligned = i - (i % segment)
    o_aligned = offset - (offset % segment)
    o_unaligned = (i + offset) % segment
    return (i_aligned + o_aligned + o_unaligned) % n


def flush_to_zero(x: torch.Tensor) -> torch.Tensor:
    """Subnormal floats become (signed) zero, as under FTZ/DAZ."""
    return torch.where(x.abs() < _FLT_MIN, x * 0.0, x)


#: The CUDA type of each plane dtype's word, as the profiler prints a
#: kernel's template argument, and its code at the C entry points
#: (``PLANE_F32``, ``PLANE_BF16``, ``PLANE_F16`` in ``common.cuh``).
PLANE_WORDS = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16", torch.float16: "__half"}
PLANE_CODES = {dt: code for code, dt in enumerate(PLANE_WORDS)}


def canonical_plane_dtype(plane_dtype) -> torch.dtype:
    """Validate a ``plane_dtype`` spec value (a name of ``PLANE_DTYPES``, a
    ``torch.dtype``, or None for float32) and return its dtype."""
    if plane_dtype is None:
        return torch.float32
    name = str(plane_dtype).removeprefix("torch.")
    if name not in PLANE_DTYPES:
        raise ValueError(f"plane_dtype must be one of {PLANE_DTYPES}; got {plane_dtype!r}")
    return getattr(torch, name)


def plane_itemsize(plane_dtype) -> int:
    """Bytes per plane word: 4, 2, 2."""
    return canonical_plane_dtype(plane_dtype).itemsize


def quantise_plane(x: torch.Tensor, plane_dtype="float32") -> torch.Tensor:
    """Round ``x`` onto the ``plane_dtype`` grid, keeping its own dtype:
    ``x.to(plane).to(x.dtype)``.  The same tensor, with no work, where ``x``
    already has the plane dtype (float32 at float32) and for non-float
    tensors (int states pass through).  Idempotent, so narrowing a quantised
    tensor (``compress_plane``) loses nothing."""
    if not x.is_floating_point():
        return x
    dt = canonical_plane_dtype(plane_dtype)
    return x if x.dtype == dt else x.to(dt).to(x.dtype)


def compress_plane(x: torch.Tensor, plane_dtype="float32") -> torch.Tensor:
    """Narrow a float plane to the word the kernels move (``x`` itself
    when it has it); non-float planes keep their dtype.  Of any float
    ``x``, the values of ``quantise_plane(x)``."""
    if not x.is_floating_point():
        return x
    return x.to(canonical_plane_dtype(plane_dtype))


def state_itemsize(particles: torch.Tensor, plane_dtype) -> int:
    """Bytes per state word under the compression axis: the plane word for
    a float state, the state's own width otherwise (int states never
    compress)."""
    if particles.is_floating_point():
        return plane_itemsize(plane_dtype)
    return particles.element_size()


def step_stats(lw: torch.Tensor):
    """Fused-step prelude over the last axis of log-weights ``[..., N]``:
    ``(m, ess_norm, log_evidence_incr, max_weight, degenerate)``.

    Term for term as ``repro.kernels.common.step_stats``: the guarded shift
    by the max, ``(Σw)²/max(Σw², 1e-30)``, ``m + log(Σw) - log(N)`` and
    ``max(w)/max(Σw, 1e-30)``; a degenerate row (non-finite max) runs on the
    uniform ``1/N`` bank, its ``incr`` keeps the raw value.  The sums run in
    torch's order, which is not XLA's: the tests state the tolerance."""
    n = lw.shape[-1]
    lw = flush_to_zero(lw)
    m_raw = lw.amax(dim=-1)
    deg = ~torch.isfinite(m_raw)
    m = torch.where(deg, torch.zeros_like(m_raw), m_raw)
    w_raw = flush_to_zero(torch.exp(flush_to_zero(lw - m.unsqueeze(-1))))
    log_n = torch.log(torch.tensor(float(n), dtype=torch.float32, device=lw.device))
    incr = (m + torch.log(w_raw.sum(dim=-1))) - log_n
    w = torch.where(deg.unsqueeze(-1), torch.full_like(w_raw, 1.0 / n), w_raw)
    s1 = w.sum(dim=-1)
    s2 = flush_to_zero(w * w).sum(dim=-1)
    ess_norm = (s1 * s1) / torch.clamp(s2, min=1e-30) / float(n)
    maxw = w.amax(dim=-1) / torch.clamp(s1, min=1e-30)
    return m, ess_norm, incr, maxw, deg


def step_select(do: torch.Tensor, k_new: torch.Tensor) -> torch.Tensor:
    """The fused step's commit: the selected ancestors where the ESS
    trigger fired, else the identity (the state copy is then a no-op)."""
    ids = tile_lane_ids(k_new.shape[-1], k_new.device)
    return torch.where(do.unsqueeze(-1), k_new, ids)


def step_weights(lw: torch.Tensor, thr: float):
    """The plain step kernels' prelude over log-weights ``[S, N]`` of a plane
    dtype: ``(w, do, stats)`` with the sweep's weights ``exp(lw - m)``
    (uniform ``1/N`` on a degenerate row) requantised to that dtype, the
    trigger ``ess_norm < thr`` and
    ``stats f32[S, 4] = (ess_norm, incr if do else 0, do, max_weight)``."""
    n = lw.shape[-1]
    lw32 = lw.to(torch.float32)
    m, ess_norm, incr, maxw, deg = step_stats(lw32)
    do = ess_norm < torch.tensor(thr, dtype=torch.float32)
    w = flush_to_zero(torch.exp(flush_to_zero(flush_to_zero(lw32) - m.unsqueeze(-1))))
    w = torch.where(deg.unsqueeze(-1), torch.full_like(w, 1.0 / n), w)
    # The sweep's weights land on the log-weights' plane grid (JAX's
    # ``w.astype(lw.dtype).astype(f32)``); the stats above are of the f32 w.
    w = quantise_plane(w, lw.dtype)
    stats = torch.stack(
        [ess_norm, torch.where(do, incr, torch.zeros_like(incr)), do.to(torch.float32), maxw],
        dim=-1,
    )
    return w, do, stats


def to_planes(particles: torch.Tensor, lead: int) -> torch.Tensor:
    """Particles ``[..., N, *state]`` with ``lead`` leading axes (1 for one
    population, 2 for a bank) -> the kernels' state ``[..., D, N]`` (a view
    when D == 1)."""
    n = particles.shape[lead - 1]
    flat = particles.reshape(particles.shape[:lead] + (-1,))
    if flat.shape[-1] == 1:
        return flat.reshape(particles.shape[: lead - 1] + (1, n))
    return flat.transpose(-1, -2).contiguous()


def from_planes(out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The kernels' state ``[..., D, N]`` -> particles shaped as ``like``."""
    return out.transpose(-1, -2).reshape(like.shape)


def gather_state(state: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``out[s, :, i] = state[s, :, k[s, i]]`` (a bit copy)."""
    return torch.gather(state, 2, k.unsqueeze(1).expand(-1, state.shape[1], -1))


def check_bank(who: str, w: torch.Tensor, state, seeds, planes=("float32",),
               state_planes=None, int_state=False):
    """Validate the arguments every bank kernel takes: weights ``[S, N]`` of
    a dtype of ``planes`` (the plane dtypes the kernel is built for), state
    ``[S, D, N]`` (or None for an index-only kernel; on the card of the
    weights' dtype, or with ``state_planes`` of any of those dtypes: the
    prefix-sum searches take a float32 CDF and copy 2-byte state; with
    ``int_state`` also of an ``INT_STATE_DTYPES`` dtype beside float32
    weights, which the wrapper hands to the kernel as ``as_state_words``
    gives it; beside a 2-byte plane that raises, naming ``INT_STATE_ITEM``)
    and ``seeds [S]`` (None for the prefix-sum kernels, which take no seed).
    Returns ``(S, N, D)`` (D = 0 without state)."""
    dtypes = tuple(canonical_plane_dtype(p) for p in planes)
    if w.dtype not in dtypes or w.ndim != 2:
        names = "/".join(str(d).removeprefix("torch.") for d in dtypes)
        raise ValueError(f"{who}: weights must be {names}[S, N]; got {w.dtype}{list(w.shape)}")
    s, n = w.shape
    if n % TILE != 0 or not 0 < n <= MAX_PARTICLES:
        raise ValueError(f"{who} requires 0 < N <= 2**30 and N % {TILE} == 0; got N={n}")
    if not 0 < s <= MAX_ROWS:
        raise ValueError(f"{who}: between 1 and {MAX_ROWS} rows per launch; got {s}")
    if s * n >= 1 << 31:
        raise ValueError(f"{who}: S·N must stay below 2**31 (int32 indices); got {s}·{n}")
    if seeds is not None and seeds.shape != (s,):
        raise ValueError(f"{who}: seeds must be [S]; got {list(seeds.shape)}")
    if state is not None and (state.ndim != 3 or state.shape[0] != s or state.shape[2] != n):
        raise ValueError(f"{who}: state must be [S, D, N] = [{s}, D, {n}]; got {list(state.shape)}")
    if w.is_cuda:
        if not w.is_contiguous():
            raise ValueError(f"{who}: weights must be contiguous")
        if state is not None:
            if state.device != w.device:
                raise ValueError(f"{who}: state on {state.device}, weights on {w.device}")
            if int_state and state.dtype in INT_STATE_DTYPES:
                if w.dtype != torch.float32:
                    raise ValueError(
                        f"{who}: an integer state rides only beside float32 weights (the "
                        f"float32 instance copies its 4-byte words); got {w.dtype} weights "
                        f"and {state.dtype} state: {INT_STATE_ITEM}")
            elif state_planes is None and state.dtype != w.dtype:
                raise ValueError(f"{who}: the CUDA kernel copies state of the weights' plane "
                                 f"dtype {w.dtype}; got {state.dtype}")
            if state_planes is not None and state.dtype not in tuple(
                    canonical_plane_dtype(p) for p in state_planes):
                raise ValueError(f"{who}: the CUDA kernel copies state of a plane dtype of "
                                 f"{tuple(state_planes)}; got {state.dtype}")
            if not state.is_contiguous():
                raise ValueError(f"{who}: state must be contiguous")
    elif state is not None and state.is_cuda:
        raise ValueError(f"{who}: state on {state.device}, weights on the CPU")
    return s, n, 0 if state is None else state.shape[1]


def as_state_words(state: torch.Tensor) -> torch.Tensor:
    """The state as the kernel's words: an ``INT_STATE_DTYPES`` tensor as a
    float32 view of its bits (no copy, no conversion), any other as it is.
    A kernel's output of that view is ``.view(state.dtype)`` again."""
    return state.view(torch.float32) if state.dtype in INT_STATE_DTYPES else state


def check_aligned(who: str, w: torch.Tensor):
    """The Megopolis and C1/C2 kernels copy whole segments of 1024 plane
    words (4 KiB of float32, 2 KiB of a 2-byte word) of ``w`` into shared
    memory by bulk copies, whose addresses and sizes come in 16-byte
    grains: a contiguous ``[S, N]`` tensor from the allocator starts on
    one, a view with an odd storage offset may not (no silent copy).  The
    check is of bytes, whatever the word."""
    if w.data_ptr() % 16:
        raise ValueError(f"{who}: the weights must start on a 16-byte boundary for the "
                         f"kernel's bulk copies; got address {w.data_ptr():#x} (a view "
                         f"with a storage offset of {w.storage_offset()} words of "
                         f"{w.element_size()} bytes): pass a copy")


def device_seeds(seeds: torch.Tensor, device) -> torch.Tensor:
    """uint32 seeds (``int64``, possibly on the host) as the int32 bit
    patterns a kernel reads as ``uint32_t``, on ``device``."""
    return seed_bits(seeds.to(torch.int64)).to(device)


def check_launch(err: int, who: str):
    """Raise when a kernel's C entry returned a CUDA error."""
    if err != 0:
        raise KernelLaunchError(f"{who}: CUDA error {err} at launch")


def step_buffers(grid_fn, who: str, lw: torch.Tensor, state: torch.Tensor, num_iters: int,
                 wbuf_word=None):
    """The grid and buffers of one cooperative step launch over ``lw [S,
    N]``: the co-resident block count from the library's ``grid_fn(S, N,
    &blocks)`` on the weights' device, then the outputs and the scratch of
    ``common.cuh``'s ``StepScratch`` layout (its weights buffer of ``S·N``
    words of ``lw``'s plane dtype, or of ``wbuf_word`` bytes: the prefix-sum
    step keeps them as float32), with 16 bytes of slack so that a kernel
    may start its weights buffer on a 16-byte boundary.  Returns
    ``(blocks, ancestors, state', stats, scratch)``."""
    s, n = lw.shape
    if s > MAX_STEP_ROWS:
        raise ValueError(f"{who}: at most {MAX_STEP_ROWS} rows per step launch; got {s}")
    blocks = ctypes.c_int(0)
    with torch.cuda.device(lw.device):
        check_launch(grid_fn(s, n, ctypes.byref(blocks)), who)
    g = blocks.value
    anc = torch.empty((s, n), dtype=torch.int32, device=lw.device)
    stats = torch.empty((s, 4), dtype=torch.float32, device=lw.device)
    wbuf = -(-s * n * (wbuf_word or lw.element_size()) // 4)
    scratch = torch.empty(s * g * 5 + s * num_iters + wbuf + 4, dtype=torch.float32,
                          device=lw.device)
    return g, anc, torch.empty_like(state), stats, scratch


#: Observers of the wrappers' launches (``repro_torch.analysis`` adds them):
#: objects with ``launched(kernel, wrapper, args, out)``.
_LAUNCH_OBSERVERS: list = []
#: Wrapper calls in progress: a wrapper called inside another is part of
#: that one's work, not a launch of its own.
_DEPTH = [0]


def kernel_wrapper(kernel):
    """Decorator of a kernel's launch wrapper, the launch census hook.
    ``kernel`` names the CUDA kernel the wrapper launches as the profiler
    prints it (``copy_kernel``), or is a function of
    the call's arguments that gives the name.

    While an observer is installed, each call reports one launch to it, on
    both devices (on a CPU tensor the plain version stands for the launch,
    as interpret mode stands for a ``pallas_call``), with the call's
    arguments and outputs; a wrapper called inside another reports nothing.
    While the call runs, ``inside_kernel_wrapper()`` is True.  The
    wrapper's own ``launches`` count is untouched.  ``wrapper.kernel_name(
    *args)`` gives the name a call's launch reports."""

    def decorate(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _DEPTH[0] or not _LAUNCH_OBSERVERS:
                return fn(*args, **kwargs)
            _DEPTH[0] += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                _DEPTH[0] -= 1
            name = wrapper.kernel_name(*args, **kwargs)
            for observer in tuple(_LAUNCH_OBSERVERS):
                observer.launched(name, wrapper.__name__, args, out)
            return out

        wrapper.kernel_name = kernel if callable(kernel) else lambda *args, **kwargs: kernel
        return wrapper

    return decorate


def plane_word(x: torch.Tensor) -> str:
    """The CUDA type of a plane tensor's word, as the profiler prints it."""
    return PLANE_WORDS.get(x.dtype, str(x.dtype))


def plane_instance(kernel: str, *lead, of: int = 0):
    """``kernel_wrapper``'s name of a kernel templated on the plane word, as
    a function of the call: ``kernel<lead..., word>`` for the word of the
    call's positional argument ``of`` (the weights by default), each
    template argument of ``lead`` as the profiler prints it (a bool as
    ``false``/``true``): ``megopolis_fused_rows_kernel<false, __nv_bfloat16>``,
    ``metropolis_c1c2_rows_kernel<2, true, __half>``."""
    head = "".join(f"{str(a).lower() if isinstance(a, bool) else a}, " for a in lead)
    return lambda *args, **kwargs: f"{kernel}<{head}{plane_word(args[of])}>"


def inside_kernel_wrapper() -> bool:
    """True while a kernel wrapper's call runs: its tensor work (a plain
    version's gather) is the kernel's own."""
    return _DEPTH[0] > 0


@contextlib.contextmanager
def observe_launches(observer):
    """Report every wrapper call made inside the block to ``observer``."""
    _LAUNCH_OBSERVERS.append(observer)
    try:
        yield observer
    finally:
        _LAUNCH_OBSERVERS.remove(observer)
