"""Plain PyTorch versions of the prefix-sum CUDA kernels, on the same
signatures (after ``repro.kernels.prefix_sum.ref.prefix_sum_tiled_ref`` and
``prefix_resample_ref``).

The scan: an inclusive f32 scan per tile of 1024 particles, plus a carry
added strictly in tile order, ``y_t = local_t + C_t`` with ``C_0 = 0`` and
``C_{t+1} = C_t + local_t[-1]``.  The order of the adds is the contract, so
nothing here calls ``torch.cumsum`` (on the CPU it accumulates in a wider
type).  In a tile the adds follow XLA's CPU ``cumsum``, a recursive scan
with base 16 (``xla_scan``): at most 16 values are added one after the
other; more are viewed as rows of 16, each row scanned, the rows' totals
scanned the same way, and each row after the first offset by the total of
the rows before it.

The search: the TPU kernel's bisection step by step, ``ceil(log2(N + 1))``
steps from ``[0, N)``, ``left`` the first ``c >= u``, ``right`` the first
``c > u``, clipped to N - 1; NaN and unsorted input follow the loop, not
``torch.searchsorted``.  ``mid = lo + (hi - lo) // 2``, which is the TPU's
``(lo + hi) // 2`` without its int32 overflow near N = 2**30.  The kernels
read the first steps' midpoints from a copy of the CDF at the tree's nodes
(``search_tree``): the same values, so the same result.

The draws: the key-derived bases (``uniform(key, (n,))`` or the scalar
``uniform(key, ())``) come from the caller; ``scaled_draws`` applies the
CDF-dependent scale as XLA computes it on the CPU, where ``x / N`` by the
constant N is ``x·fl(1/N)`` (ROADMAP Queue C).

Flush to zero: the inputs and every float result that selection depends
on, as XLA on the CPU does (``kernels/common.py``).

Shapes: banks of S rows of N particles (N % 1024 == 0), state ``[S, D,
N]``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.common import (
    TILE,
    flush_to_zero,
    gather_state,
    step_select,
    step_weights,
)

PREFIX_KINDS = (
    "multinomial",
    "systematic",
    "improved_systematic",
    "stratified",
    "residual",
)
#: The kernels' KIND of each kind: improved systematic is systematic's
#: search with the same draws (``repro.kernels.prefix_sum.ops``).
KIND_CODES = {"multinomial": 0, "systematic": 1, "improved_systematic": 1, "stratified": 2,
              "residual": 3}
#: Base of XLA-CPU's recursive in-tile scan.
SCAN_BASE = 16
#: Largest N of ``residual``: its counts are scanned and summed in f32,
#: exact only up to 2**24 (so in the JAX package too).
RESIDUAL_MAX_PARTICLES = 1 << 24


def _add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return flush_to_zero(a + b)


def sequential_scan(v: torch.Tensor) -> torch.Tensor:
    """Inclusive scan along the last axis, one add after the other."""
    out = torch.empty_like(v)
    acc = v[..., 0]
    out[..., 0] = acc
    for j in range(1, v.shape[-1]):
        acc = _add(acc, v[..., j])
        out[..., j] = acc
    return out


def xla_scan(v: torch.Tensor) -> torch.Tensor:
    """Inclusive scan along the last axis in XLA-CPU's order (base 16); a
    length that is no multiple of 16 is padded with zeros at the end, as
    XLA's reduce-window rewrite pads it (the adds of zero change nothing)."""
    n = v.shape[-1]
    if n <= SCAN_BASE:
        return sequential_scan(v)
    m = -(-n // SCAN_BASE) * SCAN_BASE
    p = torch.nn.functional.pad(v, (0, m - n)) if m > n else v
    loc = sequential_scan(p.reshape(p.shape[:-1] + (m // SCAN_BASE, SCAN_BASE)))
    tot = xla_scan(loc[..., -1])
    out = loc.clone()
    out[..., 1:, :] = _add(loc[..., 1:, :], tot[..., :-1, None])
    return out.reshape(p.shape)[..., :n]


def scan_rows_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``prefix_scan_rows_kernel``: the tiled inclusive
    scan of each row of ``x f32[S, N]``."""
    s, n = x.shape
    local = xla_scan(flush_to_zero(x.to(torch.float32)).reshape(s, n // TILE, TILE))
    carry = torch.empty(s, n // TILE, dtype=torch.float32, device=x.device)
    c = torch.zeros(s, dtype=torch.float32, device=x.device)
    for t in range(n // TILE):
        carry[:, t] = c
        c = _add(c, local[:, t, -1])
    return _add(local, carry.unsqueeze(-1)).reshape(s, n)


def bisect_ref(cdf: torch.Tensor, u: torch.Tensor, right: bool) -> torch.Tensor:
    """The search kernels' bisection of each row of ``cdf f32[S, N]`` at the
    values ``u f32[S, M]``: ``int64[S, M]``."""
    lo = torch.zeros(u.shape, dtype=torch.int64, device=u.device)
    return bisect_steps(cdf, u, right, lo, torch.full_like(lo, cdf.shape[-1]))


def bisect_steps(cdf: torch.Tensor, u: torch.Tensor, right: bool, lo: torch.Tensor,
                 hi: torch.Tensor) -> torch.Tensor:
    """``bisect_ref``'s loop from the intervals ``[lo, hi)`` (``int64[S,
    M]``) on: ``ceil(log2(N + 1))`` steps, each a no-op once ``lo >= hi``;
    returns ``lo`` clipped to N - 1."""
    n = cdf.shape[-1]
    cdf, u = flush_to_zero(cdf), flush_to_zero(u)
    for _ in range(max(1, math.ceil(math.log2(n + 1)))):
        active = lo < hi
        mid = lo + (hi - lo) // 2
        cm = torch.gather(cdf, 1, mid.clamp(max=n - 1))
        pred = cm <= u if right else cm < u
        lo = torch.where(active & pred, mid + 1, lo)
        hi = torch.where(active & ~pred, mid, hi)
    return lo.clamp(max=n - 1)


#: Floats of a line of the search kernels' tree: one 32-byte sector, the 7
#: nodes of three steps under one node and one unused.
TREE_LINE = 8


def search_tree_lines(n: int) -> range:
    """The lines of the search kernels' tree of a row of N (``tree_groups``
    and ``tree_lines`` in ``csrc/prefix_sum.cu``): groups of three steps,
    as many as leave at most 16 elements to the last steps,
    ``ceil((ceil(log2 N) - 4) / 3)``; group g holds 8**g lines."""
    steps = (n - 1).bit_length()
    groups = 1 if steps <= 7 else (steps - 2) // 3
    return range(((1 << (3 * groups)) - 1) // 7)


def search_tree(n: int) -> torch.Tensor:
    """The search kernels' tree of a row of N as the CDF indices its floats
    hold (-1: no node there): line r of group g (after the ``(8**g - 1) /
    7`` lines of the groups before) holds ``tree_nodes``' nodes of steps
    3g .. 3g + 2 under node ``8**g + r``, breadth first (its root, its two
    children, their four), then one unused float.  ``int64[TREE_LINE·lines]``."""
    lines = len(search_tree_lines(n))
    groups = (lines * 7 + 1).bit_length() // 3
    nodes = tree_nodes(n, 3 * groups)
    out = torch.full((lines, TREE_LINE), -1, dtype=torch.int64)
    for g in range(groups):
        first = ((1 << (3 * g)) - 1) // 7
        roots = torch.arange(1 << (3 * g)) + (1 << (3 * g))  # nodes 8**g + r
        for k in range(TREE_LINE - 1):
            depth = (k + 1).bit_length() - 1
            v = (roots << depth) + (k + 1 - (1 << depth))
            out[first:first + len(roots), k] = nodes[v - 1]
    return out.reshape(-1)


def tree_nodes(n: int, levels: int) -> torch.Tensor:
    """The search kernels' tree (``tree_node`` in ``csrc/prefix_sum.cu``):
    the index of the CDF that the bisection over ``[0, N)`` reads at each of
    its first ``levels`` steps, node ``v = 1 .. 2**levels - 1`` at position
    ``v - 1`` in breadth-first order (node v's children are 2v, where the
    step went left, ``hi = mid``, and 2v + 1, right, ``lo = mid + 1``); -1
    where the node's interval is empty, so that no search reads it.
    ``int64[2**levels - 1]``."""
    lo = torch.zeros(1, dtype=torch.int64)
    hi = torch.full((1,), n, dtype=torch.int64)
    nodes = []
    for _ in range(levels):
        mid = lo + (hi - lo) // 2
        nodes.append(torch.where(lo < hi, mid, -1))
        lo = torch.stack([lo, mid + 1], dim=1).reshape(-1)
        hi = torch.stack([mid, hi], dim=1).reshape(-1)
    return torch.cat(nodes)


def _result(k: torch.Tensor, state: Optional[torch.Tensor]):
    if state is None:
        return k.to(torch.int32)
    return k.to(torch.int32), gather_state(state, k)


def search_rows_ref(cdf: torch.Tensor, u: torch.Tensor, right: bool,
                    state: Optional[torch.Tensor] = None):
    """Plain version of ``prefix_search_rows_kernel<GATHER>`` and
    ``prefix_search_tree_kernel<GATHER, false>``:
    ancestors ``int32[S, N]``, and with ``state`` the copy of each
    ancestor's state ``[S, D, N]``."""
    return _result(bisect_ref(cdf, u, right), state)


def _slots(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def _residual_select(cc, c, u, n_det) -> torch.Tensor:
    s, n = c.shape
    slots = _slots(n, c.device)
    det = bisect_ref(cc, slots.to(torch.float32).expand(s, n), True)
    n_det = n_det.to(device=c.device, dtype=torch.int64).unsqueeze(-1)
    return torch.where(slots < n_det, det, bisect_ref(c, u, True))


def residual_select_rows_ref(cc: torch.Tensor, c: torch.Tensor, u: torch.Tensor,
                             n_det: torch.Tensor, state: Optional[torch.Tensor] = None):
    """Plain version of ``prefix_search_tree_kernel<true, true>``: slot
    ``i < n_det[s]`` takes the ``right`` bisection of the count CDF ``cc`` at
    ``i``, every other slot that of the residual CDF ``c`` at ``u``."""
    return _result(_residual_select(cc, c, u, n_det), state)


def draws_rise(kind: str) -> bool:
    """The draws rise with the slot (the systematic and stratified kinds):
    they go to the one-thread-a-slot search kernel, the others to the tree
    search (``search.py``)."""
    return not side_is_right(kind)


def side_is_right(kind: str) -> bool:
    """``right`` (first ``c > u``) for multinomial and residual, ``left``
    (first ``c >= u``) for the stratified and systematic kinds."""
    return kind in ("multinomial", "residual")


def scaled_draws(kind: str, total: torch.Tensor, n: int, ubase=None, u0=None) -> torch.Tensor:
    """The search values ``f32[S, N]`` of each row from its CDF total
    ``total [S]`` and the key-derived bases: ``ubase·total`` (multinomial,
    and residual on its residual CDF), ``(i + u0)·(total / N)`` (the
    systematic kinds, ``u0 [S]``), ``(i + ubase)·(total / N)``
    (stratified)."""
    total = total.to(torch.float32).unsqueeze(-1)
    if side_is_right(kind):
        return flush_to_zero(ubase * total)
    one = torch.ones((), dtype=torch.float32, device=total.device)
    scale = flush_to_zero(total * (one / torch.full_like(one, n)))  # x / N as x·fl(1/N)
    idx = _slots(n, total.device).to(torch.float32)
    base = u0.to(total.device, torch.float32).unsqueeze(-1) if KIND_CODES[kind] == 1 else ubase
    return flush_to_zero((idx + base) * scale)


def residual_parts(w: torch.Tensor, total: torch.Tensor):
    """Residual resampling's split of flushed weights ``w [S, N]`` with CDF
    totals ``total [S]``: ``(counts, resid, n_det)`` with ``counts =
    floor(N·w/total)``, ``resid = N·w/total - counts`` and ``n_det int64[S]``
    the sum of the counts (exact in f32 up to 2**24; NaN gives 0, as
    XLA's conversion)."""
    n = w.shape[-1]
    nw = flush_to_zero(flush_to_zero(w / total.unsqueeze(-1)) * float(n))
    counts = torch.floor(nw)
    resid = flush_to_zero(nw - counts)
    tot = counts.to(torch.float64).sum(dim=-1)
    n_det = torch.where(torch.isnan(tot), 0.0, tot.clamp(-2.0**31, 2.0**31 - 1))
    return counts, resid, n_det.to(torch.int64)


def select_rows_ref(kind: str, w: torch.Tensor, ubase=None, u0=None) -> torch.Tensor:
    """The composed resample of one kind over flushed weights ``w [S, N]``:
    scan, draws, search (residual: three scans, then the slot select).
    Returns ancestors ``int64[S, N]``."""
    n = w.shape[-1]
    w = flush_to_zero(w.to(torch.float32))
    c = scan_rows_ref(w)
    if kind != "residual":
        return bisect_ref(c, scaled_draws(kind, c[:, -1], n, ubase, u0), side_is_right(kind))
    counts, resid, n_det = residual_parts(w, c[:, -1])
    cc, cr = scan_rows_ref(counts), scan_rows_ref(resid)
    return _residual_select(cc, cr, scaled_draws(kind, cr[:, -1], n, ubase), n_det)


def prefix_step_rows_ref(lw: torch.Tensor, state: torch.Tensor, ubase, u0, thr: float,
                         kind: str):
    """Plain version of ``prefix_step_rows_kernel``: ``step_stats`` per row,
    the trigger ``ess_norm < thr``, the composed resample of ``kind`` on
    ``exp(lw - m)`` (uniform ``1/N`` on a degenerate row), then the
    selection or the identity.  Returns ``(ancestors int32[S, N], state'
    [S, D, N], stats f32[S, 4])``."""
    w, do, stats = step_weights(lw, thr)
    k = step_select(do, select_rows_ref(kind, w, ubase, u0))
    return k.to(torch.int32), gather_state(state, k), stats
