"""Memory-transaction cost model (paper §2.4, Figs. 1-4).

The paper's central speed argument is counted, not timed: a warp of 32
threads reading 4-byte words from global memory costs one transaction per
distinct aligned 32-byte segment touched.  This module evaluates that model
for the comparison-index streams generated by each resampler so the paper's
transaction claims (Megopolis: exactly 4/warp-iteration; Metropolis: up to
32; C1/C2: min(32, P_size/32)) are reproduced *numerically* on any host.

A numpy copy of ``repro.core.transactions``, so that the port needs nothing
of the JAX package.  On the H100 the paper's 32-byte segment is the L2
sector, the unit in which the card moves data between L2 and the SMs.
"""

from __future__ import annotations

import numpy as np


def transactions_per_group(
    indices: np.ndarray,
    *,
    group: int = 32,
    word_bytes: int = 4,
    segment_bytes: int = 32,
) -> np.ndarray:
    """Count memory transactions for one iteration's comparison indices.

    Args:
      indices: int[N] — element index each lane reads this iteration.
      group: lanes per SIMD group (warp=32; TPU sublane-row=128).
      segment_bytes: transaction granularity.

    Returns: int[ceil(N/group)] transactions per group.
    """
    n = indices.shape[0]
    n_groups = (n + group - 1) // group
    if n_groups * group != n:
        # A ragged tail group still issues transactions — pad with the last
        # lane's index so no new segments are invented for the fill lanes.
        indices = np.concatenate(
            [indices, np.repeat(indices[-1], n_groups * group - n)]
        )
    idx = indices.reshape(n_groups, group)
    seg = (idx.astype(np.int64) * word_bytes) // segment_bytes
    seg.sort(axis=1)
    new = np.concatenate([np.ones((n_groups, 1), bool), seg[:, 1:] != seg[:, :-1]], axis=1)
    return new.sum(axis=1)


def total_transactions(index_stream, **kw) -> int:
    """Sum transactions over an iterable of per-iteration index vectors."""
    return int(sum(int(transactions_per_group(ix, **kw).sum()) for ix in index_stream))


def index_streams(name: str, rng: np.ndarray, n: int, num_iters: int, **params):
    """Generate the comparison-index stream of each algorithm (cost model
    only — mirrors the j-selection lines of Algs. 2-5)."""
    rng = np.random.default_rng(rng)
    warp = params.get("warp", 32)
    word_bytes = params.get("word_bytes", 4)
    if name == "megopolis":
        segment = params.get("segment", 32)
        i = np.arange(n)
        i_al = i - (i % segment)
        for _ in range(num_iters):
            o = int(rng.integers(0, n))
            o_al = o - (o % segment)
            yield (i_al + o_al + (i + o) % segment) % n
    elif name == "metropolis":
        for _ in range(num_iters):
            yield rng.integers(0, n, size=n)
    elif name in ("metropolis_c1", "metropolis_c2"):
        # Compressed planes halve the word: the same partition byte budget
        # spans twice as many particles at word_bytes=2 (DESIGN.md §14).
        n_w = params.get("partition_size_bytes", 128) // word_bytes
        n_part = max(1, (n * word_bytes) // params.get("partition_size_bytes", 128))
        n_warps = (n + warp - 1) // warp
        i_warp = np.arange(n) // warp
        p_fixed = rng.integers(0, n_part, size=n_warps)
        for _ in range(num_iters):
            p = p_fixed if name == "metropolis_c1" else rng.integers(0, n_part, size=n_warps)
            j = p[i_warp] * n_w + rng.integers(0, n_w, size=n)
            yield np.minimum(j, n - 1)
    else:
        raise KeyError(name)


# ---------------------------------------------------------------------------
# Declared §2.4 bounds (DESIGN.md §13, pass 5)
#
# The paper's per-family transaction claims as *asserted numbers*, priced by
# the analyzer on every run instead of only being plotted by the benchmark.
# A warp-iteration is one group of 32 lanes reading one comparison index
# each; the ideal fully-coalesced cost is 128B / 32B = 4 transactions.
# ---------------------------------------------------------------------------

#: Megopolis' claim is an equality — every warp-iteration costs EXACTLY the
#: coalesced minimum whenever the coalescing segment covers the warp.
MEGOPOLIS_EXACT = 4


def declared_transaction_bound(name: str, *, warp: int = 32, word_bytes: int = 4,
                               segment_bytes: int = 32,
                               partition_size_bytes: int = 128) -> int:
    """Max transactions per warp-iteration the paper allows ``name``.

    Megopolis: exactly ``warp * word_bytes / segment_bytes`` (= 4).
    Metropolis: up to one transaction per lane (fully scattered) = 32.
    C1/C2: the warp shares a partition, so at most ``min(warp,
    partition_size_bytes / segment_bytes)`` distinct segments.
    """
    coalesced = (warp * word_bytes) // segment_bytes
    if name == "megopolis":
        return coalesced
    if name == "metropolis":
        return warp
    if name in ("metropolis_c1", "metropolis_c2"):
        return min(warp, max(coalesced, partition_size_bytes // segment_bytes))
    raise KeyError(name)


def measured_transaction_stats(name: str, *, seed: int = 0, n: int = 4096,
                               num_iters: int = 32, warp: int = 32,
                               word_bytes: int = 4, **params) -> dict:
    """Evaluate the §2.4 model on ``name``'s actual index streams and
    return ``{"max", "mean", "bound", "exact"}`` per warp-iteration.

    ``word_bytes`` prices the stream at a compressed word (DESIGN.md §14):
    at 2 a fully-coalesced warp touches half the segments, so Megopolis'
    exact-4 becomes exact-2.  ``exact`` is non-None only for Megopolis —
    the family whose claim is an equality, checked as max == mean ==
    the word-scaled MEGOPOLIS_EXACT (4 at f32)."""
    per_group = np.concatenate([
        transactions_per_group(ix, group=warp, word_bytes=word_bytes)
        for ix in index_streams(
            name, seed, n, num_iters, word_bytes=word_bytes, **params
        )
    ])
    bound = declared_transaction_bound(
        name, warp=warp, word_bytes=word_bytes,
        partition_size_bytes=params.get("partition_size_bytes", 128),
    )
    return {
        "max": int(per_group.max()),
        "mean": float(per_group.mean()),
        "bound": bound,
        "exact": (MEGOPOLIS_EXACT * word_bytes) // 4 if name == "megopolis" else None,
    }
