"""Shared kernel primitives, after ``repro.kernels.common``.

The counter-based hash RNG (murmur3 finalizer over ``(seed, particle,
iteration)``), ``key_to_seed``, the fused step's statistics prelude
``step_stats`` and its commit ``step_select`` — written once here in plain
PyTorch.  The plain versions of the CUDA kernels call them, and the CUDA
sources (``megopolis/csrc/megopolis.cu``) spell out the same arithmetic.

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

import torch

MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
LANES = 128
SUBLANES = 8
TILE = SUBLANES * LANES  # 1024 particles: the Megopolis coalescing segment
SEG = TILE
#: Largest particle count: int32 index arithmetic ``i + o + SEG`` stays
#: below 2**31.
MAX_PARTICLES = 1 << 30
PLANE_DTYPES = ("float32",)
_FLT_MIN = torch.finfo(torch.float32).tiny


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
    ``fmix(k0 ^ k1·GOLDEN)``, returned as ``int64[...]``."""
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


def quantise_plane(x: torch.Tensor, plane_dtype: str = "float32") -> torch.Tensor:
    """Round onto the plane-dtype grid: the identity at float32, the only
    plane dtype this slice ports."""
    if plane_dtype not in PLANE_DTYPES:
        raise NotImplementedError(
            f"plane_dtype={plane_dtype!r} is not ported yet (ROADMAP Queue A, "
            "item 2: compressed planes)"
        )
    return x


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
