"""Distributed Megopolis: the paper's coalescing contract at the level of
ranks, after ``repro.core.distributed`` (DESIGN.md §3).

The paper coalesces at the warp and segment level; a population sharded
over D ranks (``torch.distributed``, one block of L = N / D particles a
rank) adds one more level of the same decomposition:

    o  ~ U{0, N-1}           (one global offset per iteration, as in Alg. 5)
    o  = o_shard * L + o_local
    j  = ((s + o_shard) mod D) * L  +  megopolis_local(i_local, o_local)

Per iteration ``i -> j`` is a bijection (a rotation of the ranks' blocks
times the within-block Megopolis bijection), and ``j | o`` is uniform over
[0, N): Proposition 1 carries over, with the same B.

Communication per iteration is one contiguous block exchange between
ranks, the counterpart of a coalesced transaction:

  * ``schedule="static"``: the rank-level offsets come from a host-known
    seed (``_static_shard_schedule``), so each iteration needs the block of
    rank ``(s + o_shard) mod D``; the exchange is made once per DISTINCT
    offset of the schedule (at most D of them), a send and a receive a
    rank.  The within-block offset stays random.
  * ``schedule="dynamic"``: the rank-level offsets are drawn from the key;
    the rotation by a drawn shift is routed as log2(D) hops by a power of
    two, each exchanged and kept where the shift's bit is set (D a power
    of two), as the JAX package's hypercube of ``ppermute``s does.

The JAX package runs this under ``shard_map`` with ``ppermute``,
``all_gather`` and ``psum``; the port runs one process a rank with
``torch.distributed`` (point-to-point sends for the rotations,
``all_gather`` and ``all_reduce``), on the gloo backend on the CPU and on
NCCL on the card.  The caller creates the process group
(``init_process_group``), and every rank calls every function here with
the same key and arguments.

Ancestor payloads: ``gather_ancestors`` (exact, all-gather) or
``island_exchange`` (local resampling and a periodic ring mix, Vergé et
al.).  ``megopolis_hier_ref`` is the one-device oracle of the index map.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch import random as trandom
from repro_torch.kernels.common import (
    MASK32,
    flush_to_zero,
    hash_uniform,
    key_to_seed,
    megopolis_indices,
    murmur3_fmix,
)

#: The coalescing segment of the JAX package's distributed resampler.
DEFAULT_SEGMENT = 1024


def _world(group) -> tuple:
    """``(D, s)``: the group's size and this process's rank in it."""
    return dist.get_world_size(group), dist.get_rank(group)


def _exchange(x: torch.Tensor, shift: int, group) -> torch.Tensor:
    """The block of rank ``(s + shift) mod D`` on rank ``s``: this rank's
    block goes to rank ``(s - shift) mod D``, in one send and one receive."""
    d, s = _world(group)
    shift %= d
    if shift == 0:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    peer = (lambda r: dist.get_global_rank(group, r)) if group is not None else (lambda r: r)
    ops = [dist.P2POp(dist.isend, x, peer((s - shift) % d), group),
           dist.P2POp(dist.irecv, out, peer((s + shift) % d), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _rotate_blocks_dynamic(x: torch.Tensor, shift: torch.Tensor, group) -> torch.Tensor:
    """The block of rank ``(s + shift) mod D`` for a drawn ``shift``: log2(D)
    hops by 1, 2, 4, ..., each exchanged and kept where the shift's bit is
    set."""
    d, _ = _world(group)
    if d & (d - 1):
        raise ValueError(f"the dynamic schedule needs a power-of-two rank count; got {d}")
    bit, step = 0, 1
    while step < d:
        hopped = _exchange(x, step, group)
        x = torch.where(((shift >> bit) & 1) == 1, hopped, x)
        bit, step = bit + 1, step << 1
    return x


def _static_shard_schedule(seed: int, num_iters: int, n_shards: int) -> list:
    """The host-side rank-offset schedule: ``x_b = fmix(x_{b-1} + b + 1)``
    from ``x = seed`` (uint32), each taken modulo D."""
    out, x = [], seed & MASK32
    for b in range(num_iters):
        x = murmur3_fmix((x + b + 1) & MASK32)
        out.append(x % n_shards)
    return out


def megopolis_shard(seed, offsets_local: torch.Tensor, offsets_shard, local_weights: torch.Tensor,
                    *, num_iters: int, segment: int = DEFAULT_SEGMENT, schedule: str = "static",
                    group=None) -> torch.Tensor:
    """This rank's part of the distributed resample: ``int64[L]`` GLOBAL
    ancestor indices of its L particles.

    ``seed``: the hash seed (uint32 in ``int64``), the same on every rank;
    ``offsets_local``: ``int[B]``, uniform over [0, L); ``offsets_shard``: a
    list of ints (static) or ``int[B]`` drawn (dynamic)."""
    d, s = _world(group)
    w = flush_to_zero(local_weights.to(torch.float32))
    n_local, dev = w.shape[0], w.device
    i_local = torch.arange(n_local, dtype=torch.int64, device=dev)
    i_global = s * n_local + i_local
    offs_l = [int(o) for o in offsets_local[:num_iters].tolist()]
    k, wk = i_global, w
    rotated: dict = {}  # static: the distinct rank offsets, each exchanged once
    for b in range(num_iters):
        if schedule == "static":
            o_s = int(offsets_shard[b]) % d
            if o_s not in rotated:
                rotated[o_s] = _exchange(w, o_s, group)
            w_blk = rotated[o_s]
            src = (s + o_s) % d
        else:
            o_s = offsets_shard[b].to(torch.int64)
            w_blk = _rotate_blocks_dynamic(w, o_s, group)
            src = (s + o_s) % d
        j_local = megopolis_indices(i_local, offs_l[b], segment, n_local)
        w_j = w_blk[j_local]
        j_global = src * n_local + j_local
        u = hash_uniform(seed, i_global, b).to(dev)
        accept = flush_to_zero(u * wk) <= w_j
        k = torch.where(accept, j_global, k)
        wk = torch.where(accept, w_j, wk)
    return k


def gather_ancestors(x_local: torch.Tensor, ancestors_global: torch.Tensor, *,
                     group=None) -> torch.Tensor:
    """Exact cross-rank payload gather (the all-gather strategy): every
    rank's block gathered, then indexed by this rank's global ancestors.
    Fine at particle-filter payloads (scalar or small vector states)."""
    d, _ = _world(group)
    parts = [torch.empty_like(x_local) for _ in range(d)]
    dist.all_gather(parts, x_local.contiguous(), group=group)
    return torch.cat(parts)[ancestors_global.long()]


def island_exchange(x_local: torch.Tensor, *, fraction: float = 0.25,
                    group=None) -> torch.Tensor:
    """Ring-mix the leading ``fraction`` of this rank's particles with the
    previous rank's (island-model exchange; Vergé et al. [46]): rank ``s``
    takes the head of rank ``s - 1``."""
    d, _ = _world(group)
    m = max(1, int(x_local.shape[0] * fraction))
    head = _exchange(x_local[:m], -1 % d, group) if d > 1 else x_local[:m]
    return torch.cat([head, x_local[m:]])


def effective_sample_size(local_weights: torch.Tensor, *, group=None) -> torch.Tensor:
    """Global ESS = (Σ w)² / Σ w² over every rank's weights (two
    ``all_reduce`` sums): the resampling trigger."""
    sums = torch.stack([local_weights.sum(), (local_weights * local_weights).sum()])
    dist.all_reduce(sums, group=group)
    return sums[0] * sums[0] / torch.clamp(sums[1], min=1e-30)


def make_distributed_resampler(*, spec=None, group=None, num_iters: int = 32,
                               segment: int = DEFAULT_SEGMENT, schedule: str = "static",
                               static_seed: int = 0xA5A5):
    """Build this rank's part of the distributed resampler:
    ``fn(key, local_weights [L]) -> int64[L]`` global ancestors, the same
    key on every rank (each rank's block is ``N / D`` consecutive
    particles).

    ``spec`` (a ``MegopolisSpec`` on ``backend="reference"``, DESIGN.md §9)
    gives ``num_iters`` and ``segment``, overriding the loose arguments; the
    distributed knobs (``group``, ``schedule``, ``static_seed``) stay here.
    ``num_iters`` must be concrete (the static schedule is built per
    iteration on the host), so ``num_iters='auto'`` is refused, and so is
    ``backend="cuda"``: this runs its own decomposition, not the one-card
    kernel."""
    if spec is not None:
        from repro_torch.core.spec import MegopolisSpec

        if not isinstance(spec, MegopolisSpec):
            raise TypeError(
                f"make_distributed_resampler takes a MegopolisSpec; got {type(spec).__name__} "
                "(the hierarchical decomposition is Alg. 5's)")
        if isinstance(spec.num_iters, bool) or not isinstance(spec.num_iters, int):
            raise ValueError(
                "make_distributed_resampler needs a concrete num_iters (the rank-offset "
                f"schedule is built per iteration on the host); got {spec.num_iters!r}")
        if spec.backend != "reference":
            raise ValueError(
                "make_distributed_resampler runs its own decomposition over torch.distributed, "
                f"not the one-card kernel; got backend={spec.backend!r} "
                "(use backend='reference')")
        num_iters, segment = spec.num_iters, spec.segment
    if schedule not in ("static", "dynamic"):
        raise ValueError(f"schedule must be 'static' or 'dynamic'; got {schedule!r}")
    d, _ = _world(group)
    shard_sched = _static_shard_schedule(static_seed, num_iters, d)

    def resample(key, local_weights: torch.Tensor) -> torch.Tensor:
        n_local = local_weights.shape[0]
        k_seed, k_loc, k_shard = trandom.split(key, 3)
        seed = key_to_seed(k_seed)
        offsets_local = trandom.randint(k_loc, (num_iters,), 0, n_local)
        if schedule == "static":
            offsets_shard = shard_sched
        else:
            offsets_shard = trandom.randint(k_shard, (num_iters,), 0, d).to(local_weights.device)
        return megopolis_shard(seed, offsets_local, offsets_shard, local_weights,
                               num_iters=num_iters, segment=segment, schedule=schedule,
                               group=group)

    return resample


def megopolis_hier_ref(seed, offsets_local, offsets_shard: Sequence, weights: torch.Tensor, *,
                       n_shards: int, num_iters: int, segment: int = DEFAULT_SEGMENT,
                       ) -> torch.Tensor:
    """The one-device oracle of the hierarchical index map (for exactness
    tests of the ranks' run): ``int64[N]`` ancestors of ``weights [N]``."""
    w = flush_to_zero(weights.to(torch.float32))
    n, dev = w.shape[0], w.device
    n_local = n // n_shards
    i = torch.arange(n, dtype=torch.int64, device=dev)
    s, i_local = i // n_local, i % n_local
    offs_l = [int(o) for o in torch.as_tensor(offsets_local)[:num_iters].tolist()]
    k, wk = i, w
    for b in range(num_iters):
        o_s = offsets_shard[b]
        o_s = o_s.to(device=dev, dtype=torch.int64) if torch.is_tensor(o_s) else int(o_s)
        j_local = megopolis_indices(i_local, offs_l[b], segment, n_local)
        j_global = ((s + o_s) % n_shards) * n_local + j_local
        w_j = w[j_global]
        u = hash_uniform(seed, i, b).to(dev)
        accept = flush_to_zero(u * wk) <= w_j
        k = torch.where(accept, j_global, k)
        wk = torch.where(accept, w_j, wk)
    return k


__all__ = ["effective_sample_size", "gather_ancestors", "island_exchange",
           "make_distributed_resampler", "megopolis_hier_ref", "megopolis_shard"]
