"""The port's prefix-sum kernels (paper §6.5: multinomial, systematic,
improved systematic, stratified, residual; plain versions on the CPU)
against the JAX package's Pallas kernels in interpret mode, at kernel, entry
and filter level.

* Scan, searches and every entry of every kind take linear weights:
  ancestors, CDFs and states must match bit for bit, on zero weights (flat
  CDF runs), equal weights (systematic draws on the CDF's steps), subnormal
  and tiny-normal rows, one dominant weight and a NaN row.
* ``step`` from raw log-weights: torch's ``exp`` is 1 ULP off XLA's on some
  inputs and the stats' sums run in another order, so the stats are held to
  ``STATS_RTOL``/``INCR_ATOL`` and the ancestors to a mismatch rate of at
  most ``MAX_MISMATCH_RATE``, the bounds of ``test_torch_rejection.py``
  (a 1-ULP weight can move a CDF step past a draw, and for residual move
  ``floor(N·w)`` and so every later slot; the test prints the rate); fed
  the weights JAX normalised, the port's ``apply`` equals JAX's step bit
  for bit.
* The scan kernel's own arithmetic, written out in torch: each tile's
  total in the association of its scan, and the per-span folds of the
  carry on the kernel's grids.  These document the design and do not test
  the kernel: the torch transcript is checked against the plain version,
  and only the card tests (``tests/test_torch_cuda.py``) run the kernel.
* Filters: the Alg. 6 replay bit for bit, and a whole Alg. 6 run on the JAX
  model's arithmetic to the order of the mean's sum; whole runs on the
  port's own UNGM with their RMSE within ``WHOLE_RUN_ATOL``, the bound of
  ``test_torch_pf.py`` (see ``test_run_filter_matches`` for why not each
  step's estimate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.metrics import normalise_log_weights as jax_normalise
from repro.core.spec import PrefixSumSpec as JaxSpec
from repro.kernels.prefix_sum import search as js
from repro.kernels.prefix_sum.prefix_sum import prefix_sum_pallas
from repro.kernels.prefix_sum.ref import prefix_sum_tiled_ref
from repro.kernels.prefix_sum.step import prefix_pallas_step
from repro.pf import filter as jf
from repro.pf import models as jm
from repro_torch import convert
from repro_torch import random as trandom
from repro_torch.core.spec import PrefixSumSpec
from repro_torch.kernels.common import flush_to_zero
from repro_torch.kernels.prefix_sum import ops as pops
from repro_torch.kernels.prefix_sum import prefix_sum as pk
from repro_torch.kernels.prefix_sum import ref
from repro_torch.kernels.prefix_sum import search as sk
from repro_torch.kernels.prefix_sum import step as stk
from repro_torch.pf import filter as tf
from repro_torch.pf import models as tm

STATS_RTOL = 2e-6
INCR_ATOL = 2e-6
MAX_MISMATCH_RATE = 1e-3
WHOLE_RUN_ATOL = 0.05
KINDS = ref.PREFIX_KINDS
WEIGHTS = ("gamma", "zeros", "equal", "subnormal", "tiny_normal", "dominant", "nan")


@pytest.fixture(autouse=True)
def _partitionable():
    assert jax.config.jax_threefry_partitionable


def _weights(kind: str, shape, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    w = rng.gamma(0.5, size=shape).astype(np.float32)
    if kind == "zeros":  # runs of zero weights: flat stretches of the CDF
        w[..., 100:900] = 0.0
        w[..., ::3] = 0.0
    elif kind == "equal":
        w[...] = 1.0
    elif kind == "subnormal":
        w = np.exp(-0.5 * rng.uniform(0, 14, size=shape) ** 2).astype(np.float32)
        w[..., ::7] = np.float32(1e-39)
    elif kind == "tiny_normal":
        w = (rng.uniform(1.0, 4.0, size=shape) * 1.5e-38).astype(np.float32)
    elif kind == "dominant":
        w = (rng.uniform(size=shape) * 1e-6).astype(np.float32)
        w[..., 777] = 1.0
    elif kind == "nan":
        w[..., 5] = np.nan
    return w


def _bank(kinds, n, seed=0) -> np.ndarray:
    return np.stack([_weights(k, n, seed=seed + i) for i, k in enumerate(kinds)])


def _log_weights(kind, shape, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return (rng.normal(size=shape) * 3).astype(np.float32)
    if kind == "ungm":
        return (-0.5 * rng.uniform(0, 12, size=shape) ** 2).astype(np.float32)
    if kind == "dead":
        return np.full(shape, -np.inf, np.float32)
    raise ValueError(kind)


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.int32)


def _r2(x: np.ndarray):
    return jnp.asarray(x.reshape(-1, 128))


# ---------------------------------------------------------------- kernel level
@pytest.mark.parametrize("n", (2048, 8192))
@pytest.mark.parametrize("wkind", WEIGHTS)
def test_scan_bits(n, wkind):
    """Row 25: the scan against ``prefix_sum_pallas`` and the tiled oracle,
    every bit, NaN included."""
    x = _weights(wkind, n, seed=n)
    want = np.asarray(prefix_sum_pallas(_r2(x), interpret=True)).reshape(n)
    np.testing.assert_array_equal(_bits(np.asarray(prefix_sum_tiled_ref(jnp.asarray(x)))),
                                  _bits(want))
    got = pops.prefix_sum_cuda(torch.from_numpy(x))  # prefix_sum_tpu's counterpart
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_scan_bank_rows_restart():
    """A bank of three rows: each row's carry starts at 0."""
    x = _bank(("gamma", "subnormal", "zeros"), 8192, seed=3)
    got = pk.prefix_sum_rows(torch.from_numpy(x)).numpy()
    for r in range(3):
        want = np.asarray(prefix_sum_pallas(_r2(x[r]), interpret=True)).reshape(-1)
        np.testing.assert_array_equal(_bits(got[r]), _bits(want))


def test_scan_is_not_torch_cumsum():
    """The plain scan follows XLA's order; ``torch.cumsum`` on the CPU does
    not (it accumulates in a wider type)."""
    x = torch.from_numpy(_weights("gamma", 8192, seed=5))
    assert not torch.equal(ref.scan_rows_ref(x[None])[0], torch.cumsum(x, 0))


def _scan_kernel_rows(seed: int, n: int) -> torch.Tensor:
    """Rows with NaN, infinities, subnormals, signed tiny normals (sums
    below 2^-126), zeros and -0.0, beside gamma weights."""
    rng = np.random.default_rng(seed)
    x = np.stack([_weights(k, n, seed=seed + i) for i, k in
                  enumerate(("gamma", "nan", "subnormal", "zeros"))]
                 + [(rng.normal(size=n) * 1e3).astype(np.float32) for _ in range(3)])
    x[4, 7], x[4, n - 3] = np.inf, -np.inf
    x[5] = (rng.uniform(1.0, 2.0, size=n) * 1.2e-38 * (-1.0) ** np.arange(n)).astype(np.float32)
    x[6, : n // 2] = -0.0
    return torch.from_numpy(x)


def _tile_totals(x: torch.Tensor, association: str) -> torch.Tensor:
    """Phase 1 of ``prefix_scan_rows_kernel``: each tile's total ``[S, T]``.
    ``"scan"``: element 1023 of the tile's scan, as the kernel's last lane
    forms it, ``r63 + (g3[14] + L2[2])`` (row 63's own scan, plus the level-1
    scan before it: element 14 of level-1 row 3 plus the level-2 scan of
    rows 0-2); ``"reduction"``: the same three terms added the other way
    round, ``L2[2] + (g3[14] + r63)``, as a plain reduction would."""
    s, n = x.shape
    rows = ref.sequential_scan(ref.flush_to_zero(x).reshape(s, n // 1024, 64, 16))
    r = rows[..., 15]                                   # the 64 row totals
    g = ref.sequential_scan(r.reshape(s, n // 1024, 4, 16))  # level 1
    l2 = ref._add(ref._add(g[..., 0, 15], g[..., 1, 15]), g[..., 2, 15])
    if association == "scan":
        return ref._add(r[..., 63], ref._add(g[..., 3, 14], l2))
    return ref._add(l2, ref._add(g[..., 3, 14], r[..., 63]))


def _fold(tot: torch.Tensor) -> torch.Tensor:
    """The carries ``C_{t+1} = C_t + total_t`` from ``C_0 = 0``, ``[S, T]``."""
    c = torch.zeros(tot.shape[0], dtype=torch.float32)
    out = torch.empty_like(tot)
    for t in range(tot.shape[1]):
        c = ref._add(c, tot[:, t])
        out[:, t] = c
    return out


@pytest.mark.parametrize("n", (1024, 8192))
def test_scan_tile_total_association(n):
    """The scan kernel's phase 1, as a transcript (it documents the
    arithmetic; the kernel runs only in the card tests): the last lane's
    total, folded into carries, gives the plain scan at every tile end bit
    for bit (NaN, infinities, subnormals, zeros); the same terms in a
    reduction's order give other bits on some seed, so the kernel must not
    reduce."""
    x = _scan_kernel_rows(n, n)
    want = ref.scan_rows_ref(x)[:, 1023::1024]
    got = _fold(_tile_totals(x, "scan"))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    local = ref.xla_scan(ref.flush_to_zero(x).reshape(x.shape[0], -1, 1024))[..., -1]
    assert torch.equal(_tile_totals(x, "scan").view(torch.int32), local.view(torch.int32))
    differs = [seed for seed in range(8) if not torch.equal(
        _tile_totals(_scan_kernel_rows(seed, n), "scan"),
        _tile_totals(_scan_kernel_rows(seed, n), "reduction"))]
    assert differs


def _span_carries(tot: torch.Tensor, blocks: int) -> torch.Tensor:
    """Phase 2 of ``scan_rows``: block b owns tiles ``[Q·b // G, Q·(b+1) //
    G)`` of the bank's Q, split at row ends; each segment folds its row's
    totals from ``C_0 = 0`` up to its first tile, then carries on through
    its tiles.  Returns each tile's carry ``[S, T]``, NaN where no block
    wrote one."""
    s, t_row = tot.shape
    q_all = s * t_row
    carry = torch.full((s, t_row), float("nan"))
    written = torch.zeros(s, t_row, dtype=torch.int64)
    for b in range(blocks):
        q0, q1 = q_all * b // blocks, q_all * (b + 1) // blocks
        seg = q0
        while seg < q1:
            r = seg // t_row
            a, e = seg - r * t_row, min(t_row, q1 - r * t_row)
            seg = r * t_row + e
            c = torch.zeros((), dtype=torch.float32)
            for t in range(a):
                c = ref._add(c, tot[r, t])
            for t in range(a, e):
                carry[r, t] = c
                written[r, t] += 1
                c = ref._add(c, tot[r, t])
    assert (written == 1).all()  # every tile in exactly one span
    return carry


@pytest.mark.parametrize("blocks", ("scan", "step", 3, 7))
@pytest.mark.parametrize("n", (1024, 1 << 14))
@pytest.mark.parametrize("s", (1, 2, 16))
def test_scan_span_carries(s, n, blocks):
    """The scan kernel's phase 2, as a transcript (it documents the
    arithmetic; ``test_prefix_scan_kernel_matches_plain_version`` runs the
    kernel on the card at these grids): the per-span folds give
    ``scan_rows_ref``'s carries bit for bit, on the grid of the scan kernel
    and of the multinomial step (``analysis/smem.py``) and on grids small
    enough that spans hold several tiles and cross row ends."""
    from repro_torch.analysis import smem

    kernel = {"scan": "prefix_scan_rows_kernel<float>",
              "step": "prefix_step_rows_kernel<0, float, unsigned int>"}
    g = smem.price(kernel[blocks], s, n).blocks if blocks in kernel else blocks
    x = _scan_kernel_rows(s, n)[np.arange(s) % 7]
    y = ref.scan_rows_ref(x)
    want = torch.cat([torch.zeros(s, 1), y[:, 1023:-1:1024]], dim=1)
    got = _span_carries(_tile_totals(x, "scan"), g)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _search_inputs(wkind, n, seed):
    w = _weights(wkind, n, seed=seed)
    c = np.array(prefix_sum_pallas(_r2(w), interpret=True)).reshape(n)
    rng = np.random.default_rng(seed + 1)
    u = (rng.uniform(size=n) * c[-1]).astype(np.float32)
    u[::9] = c[rng.integers(0, n, size=u[::9].shape)]  # draws on the CDF's values
    state = rng.normal(size=(2, n)).astype(np.float32)
    return w, c, u, state


@pytest.mark.parametrize("n", (2048, 8192))
@pytest.mark.parametrize("wkind", ("gamma", "zeros", "equal", "tiny_normal", "nan"))
@pytest.mark.parametrize("side", ("left", "right"))
def test_search_bits(n, wkind, side):
    """Rows 26-27: the bisection, index only and with the state copy, draws
    on the CDF's own values included (``left`` and ``right`` differ
    there)."""
    _, c, u, state = _search_inputs(wkind, n, seed=n + len(wkind))
    want = np.asarray(js.searchsorted_pallas(_r2(c), _r2(u), side=side, interpret=True))
    jk, jout = js.searchsorted_gather_pallas(_r2(c), _r2(u), jnp.asarray(state.reshape(2, -1, 128)),
                                             side=side, interpret=True)
    tc, tu = torch.from_numpy(c), torch.from_numpy(u)
    np.testing.assert_array_equal(pops.searchsorted_cuda(tc, tu, side).numpy(), want.reshape(n))
    anc, out = sk.searchsorted_gather_rows(tc[None], tu[None], torch.from_numpy(state)[None],
                                           side)
    np.testing.assert_array_equal(anc[0].numpy(), np.asarray(jk).reshape(n))
    np.testing.assert_array_equal(_bits(out[0].numpy()), _bits(np.asarray(jout).reshape(2, n)))


def test_search_bank_forms_are_rows():
    """A bank of three rows equals each row searched as a bank of one."""
    n = 2048
    rows = [_search_inputs(k, n, seed=i) for i, k in enumerate(("gamma", "zeros", "equal"))]
    c = torch.from_numpy(np.stack([r[1] for r in rows]))
    u = torch.from_numpy(np.stack([r[2] for r in rows]))
    st = torch.from_numpy(np.stack([r[3] for r in rows]))
    anc = sk.searchsorted_rows(c, u, "right")
    anc2, out = sk.searchsorted_gather_rows(c, u, st, "right")
    assert torch.equal(anc, anc2)
    for r in range(3):
        one = slice(r, r + 1)
        assert torch.equal(anc[r], sk.searchsorted_rows(c[one], u[one], "right")[0])
        assert torch.equal(out[r],
                           sk.searchsorted_gather_rows(c[one], u[one], st[one], "right")[1][0])


def _tree_rows(rkind: str, n: int) -> torch.Tensor:
    """Four rows of N for the tree's transcript: a CDF (``sorted``), random
    values (``unsorted``), or a CDF with NaN in its rows, one at the root's
    midpoint (``nan``)."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=(4, n)).astype(np.float32)
    if rkind != "unsorted":
        x = np.cumsum(np.abs(x), axis=1, dtype=np.float32)
    if rkind == "nan":
        x[0, n // 2] = np.nan
        x[1, rng.integers(0, n, size=n // 64)] = np.nan
        x[2, :] = np.nan
    return torch.from_numpy(x)


def _walk_tree(cdf: torch.Tensor, u: torch.Tensor, right: bool, levels: int):
    """The search kernels' first ``levels`` steps, written out in torch: each
    row's values at ``ref.tree_nodes`` (the tree in shared memory), walked
    from the root; each step's node is its midpoint.  Returns the
    intervals ``(lo, hi)`` the walk leaves for the loop on global memory."""
    s, n = cdf.shape
    nodes = ref.tree_nodes(n, levels)
    tree = torch.where(nodes >= 0, flush_to_zero(cdf)[:, nodes.clamp(min=0)], 0.0)
    u = flush_to_zero(u)
    lo = torch.zeros(u.shape, dtype=torch.int64)
    hi = torch.full_like(lo, n)
    v = torch.ones_like(lo)
    for _ in range(levels):
        active = lo < hi
        mid = lo + (hi - lo) // 2
        assert torch.equal(nodes[v - 1][active], mid[active])
        cm = torch.gather(tree, 1, v - 1)
        pred = cm <= u if right else cm < u
        lo = torch.where(active & pred, mid + 1, lo)
        hi = torch.where(active & ~pred, mid, hi)
        v = torch.where(active, 2 * v + pred.long(), v)
    return lo, hi


@pytest.mark.parametrize("levels", (1, 9, 14))
@pytest.mark.parametrize("n", (1024, 3 << 12, 1 << 16))
@pytest.mark.parametrize("rkind", ("sorted", "unsorted", "nan"))
def test_search_tree_walk_is_bisect(rkind, n, levels):
    """The bisection's tree in breadth-first order (``ref.tree_nodes``, of
    which the kernels' ``search_tree`` is laid out): walking its nodes for
    some levels, then ``bisect_ref``'s loop from the intervals the walk
    leaves, gives ``bisect_ref`` on both sides, on rows that are not
    monotone and rows holding NaN, for any N (levels past log2 N reach empty
    nodes, which no search reads)."""
    cdf = _tree_rows(rkind, n)
    rng = np.random.default_rng(levels)
    hi = float(np.nanmax(cdf.numpy())) if not torch.isnan(cdf).all() else 1.0
    u = torch.from_numpy((rng.uniform(-0.1, 1.1, size=(4, n)) * hi).astype(np.float32))
    u[:, ::5] = cdf[:, rng.integers(0, n, size=u[:, ::5].shape[1])]  # draws on the values
    for right in (False, True):
        lo, hi_ = _walk_tree(cdf, u, right, levels)
        got = ref.bisect_steps(cdf, u, right, lo, hi_)
        assert torch.equal(got, ref.bisect_ref(cdf, u, right))


def _walk_search_tree(cdf: torch.Tensor, u: torch.Tensor, right: bool):
    """The search kernel's walk of its tree (``tree_search``), written out in
    torch: each row's values at ``ref.search_tree``, read a line (8 floats)
    at a time for three steps, from the root's line; each step's float is
    its midpoint.  Returns the intervals ``(lo, hi)`` left to the loop on
    the CDF."""
    s, n = cdf.shape
    layout = ref.search_tree(n)
    tree = torch.where(layout >= 0, flush_to_zero(cdf)[:, layout.clamp(min=0)], 0.0)
    u = flush_to_zero(u)
    lo = torch.zeros(u.shape, dtype=torch.int64)
    hi = torch.full_like(lo, n)
    v = torch.ones_like(lo)
    groups = (len(ref.search_tree_lines(n)) * 7 + 1).bit_length() // 3
    for g in range(groups):
        line = ref.TREE_LINE * (((1 << (3 * g)) - 1) // 7 + v - (1 << (3 * g)))
        path = torch.zeros_like(lo)
        for dl in range(3):
            at = line + (1 << dl) - 1 + path
            active = lo < hi
            mid = lo + (hi - lo) // 2
            assert torch.equal(layout[at][active], mid[active])
            cm = torch.gather(tree, 1, at)
            go = active & (cm <= u if right else cm < u)
            lo = torch.where(go, mid + 1, lo)
            hi = torch.where(active & ~go, mid, hi)
            path = 2 * path + go.long()
        v = 8 * v + path
    assert bool((hi - lo <= 16).all())  # at most 16 elements of the CDF left
    return lo, hi


@pytest.mark.parametrize("n", (1024, 3 << 12, 1 << 16))
@pytest.mark.parametrize("rkind", ("sorted", "unsorted", "nan"))
def test_search_tree_lines_walk_is_bisect(rkind, n):
    """Rows 26-28's tree as the kernel lays it out, as a transcript
    (``test_prefix_search_tree_kernels`` in ``tests/test_torch_cuda.py``
    runs the kernel): a line of 8 floats for every three steps, then
    ``bisect_ref``'s loop on at most 16 elements, gives ``bisect_ref`` on
    both sides, on rows that are not monotone and rows holding NaN."""
    cdf = _tree_rows(rkind, n)
    rng = np.random.default_rng(n + 1)
    top = float(np.nanmax(cdf.numpy())) if not torch.isnan(cdf).all() else 1.0
    u = torch.from_numpy((rng.uniform(-0.1, 1.1, size=(4, n)) * top).astype(np.float32))
    u[:, ::5] = cdf[:, rng.integers(0, n, size=u[:, ::5].shape[1])]
    for right in (False, True):
        lo, hi = _walk_search_tree(cdf, u, right)
        assert torch.equal(ref.bisect_steps(cdf, u, right, lo, hi), ref.bisect_ref(cdf, u, right))


@pytest.mark.parametrize("n", (3072, 4096))
@pytest.mark.parametrize("kind", ("multinomial", "residual"))
def test_step_tree_walk_is_bisect(kind, n):
    """Row 29's search of random draws as a transcript: on the step's own
    CDF rows (``step_weights``, the scan; for residual the residuals'
    CDF) with its scaled draws, the walk of ``ref.search_tree`` over each
    fired row's tree, then the loop on at most 16 elements, gives
    ``bisect_ref``: on UNGM and normal rows, a dead row and a row holding
    NaN (both degenerate: the uniform 1/N, whose CDF steps are equal), with
    every row fired, for N a power of two and not."""
    lw = np.stack([_log_weights("ungm", n, seed=1), _log_weights("normal", n, seed=2),
                   _log_weights("dead", n), _log_weights("normal", n, seed=3)])
    lw[3, 17] = np.nan
    w, do, _ = ref.step_weights(torch.from_numpy(lw), 2.0)
    assert bool(do.all()) and bool((w[2:] == 1.0 / n).all())
    c = ref.scan_rows_ref(w)
    if kind == "residual":
        _, resid, _ = ref.residual_parts(w, c[:, -1])
        c = ref.scan_rows_ref(resid)
    ubase = torch.from_numpy(np.random.default_rng(n).uniform(size=(4, n)).astype(np.float32))
    u = ref.scaled_draws(kind, c[:, -1], n, ubase)
    lo, hi = _walk_search_tree(c, u, True)
    assert torch.equal(ref.bisect_steps(c, u, True, lo, hi), ref.bisect_ref(c, u, True))


@pytest.mark.parametrize("n", (1024, 1 << 16, 1 << 20))
def test_search_tree_nodes_of_a_power_of_two(n):
    """For N a power of two the kernel fills its tree in closed form: node
    ``(l, p)``, ``v = 2**l + p``, is ``(2p + 1)·N / 2**(l + 1)``
    (``tree_node``); ``ref.tree_nodes`` replays the midpoints.  The tree
    fills its lines but for one float each."""
    levels = min(14, n.bit_length() - 1)
    v = torch.arange(1, 1 << levels)
    lvl = torch.floor(torch.log2(v.double())).long()
    closed = (2 * (v - (1 << lvl)) + 1) * (n >> (lvl + 1))
    assert torch.equal(ref.tree_nodes(n, levels), closed)
    layout = ref.search_tree(n).view(-1, ref.TREE_LINE)
    assert (layout[:, :-1] >= 0).all() and (layout[:, -1] == -1).all()
    assert sk.tree_floats(n) == layout.numel()


@pytest.mark.parametrize("n", (2048, 8192))
@pytest.mark.parametrize("wkind", ("gamma", "zeros", "dominant", "nan"))
def test_residual_select_bits(n, wkind):
    """Row 28 on the inputs ``ops._residual_tpu_fused`` builds."""
    w = _weights(wkind, n, seed=n + 7)
    total = np.asarray(prefix_sum_pallas(_r2(w), interpret=True)).reshape(n)[-1]
    wn = jnp.asarray(w) / total
    counts = jnp.floor(n * wn)
    n_det = jnp.sum(counts).astype(jnp.int32).reshape(1)
    resid = n * wn - counts
    cc = prefix_sum_pallas(counts.reshape(-1, 128), interpret=True)
    c = prefix_sum_pallas(resid.reshape(-1, 128), interpret=True)
    u = jax.random.uniform(jax.random.PRNGKey(n), (n,)) * c.reshape(-1)[-1]
    state = np.random.default_rng(2).normal(size=(1, n)).astype(np.float32)
    jk, jout = js.residual_select_gather_pallas(cc, c, u.reshape(-1, 128), n_det,
                                                jnp.asarray(state.reshape(1, -1, 128)),
                                                interpret=True)
    t = [torch.from_numpy(np.array(a).reshape(1, n)) for a in (cc, c, u)]
    anc, out = sk.residual_select_gather_rows(*t, torch.from_numpy(np.array(n_det)),
                                              torch.from_numpy(state)[None])
    np.testing.assert_array_equal(anc[0].numpy(), np.asarray(jk).reshape(n))
    np.testing.assert_array_equal(_bits(out[0].numpy()), _bits(np.asarray(jout).reshape(1, n)))
    # The port's own split of the weights gives the same counts and n_det.
    tcounts, tresid, tn = ref.residual_parts(torch.from_numpy(w)[None],
                                             torch.tensor([total]))
    np.testing.assert_array_equal(_bits(tcounts[0].numpy()), _bits(np.asarray(counts)))
    np.testing.assert_array_equal(_bits(tresid[0].numpy()), _bits(np.asarray(resid)))
    assert int(tn[0]) == int(n_det[0])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("thr", (0.5, 1.0))
def test_step_kernel(kind, thr, capsys):
    """Row 29 against ``prefix_pallas_step`` on the JAX draws: stats within
    the bounds, ancestors within the mismatch rate (printed), states the
    copy of the ancestors."""
    n = 4096
    lw = _log_weights("ungm", n, seed=len(kind))
    state = np.random.default_rng(4).normal(size=n).astype(np.float32)
    key = jax.random.PRNGKey(9)
    if ref.KIND_CODES[kind] == 1:
        u0, ubase = jax.random.uniform(key, ()).reshape(1), jnp.zeros((n,))
    else:
        u0, ubase = jnp.zeros((1,)), jax.random.uniform(key, (n,))
    jk, jout, jstats = prefix_pallas_step(_r2(lw), jnp.asarray(state.reshape(1, -1, 128)),
                                          ubase.reshape(-1, 128), u0, jnp.float32([thr]),
                                          kind=kind, interpret=True)
    t_ub = None if ref.KIND_CODES[kind] == 1 else torch.from_numpy(np.array(ubase))[None]
    t_u0 = torch.from_numpy(np.array(u0)) if ref.KIND_CODES[kind] == 1 else None
    anc, got, st = stk.prefix_step_rows(torch.from_numpy(lw)[None],
                                        torch.from_numpy(state)[None, None], t_ub, t_u0, thr,
                                        kind)
    rate = _check_step(anc[0], st[0], jk, jstats)
    with capsys.disabled():
        print(f"\n{kind} step kernel (threshold {thr}) vs JAX: ancestor mismatch rate "
              f"{rate:.3g}")
    np.testing.assert_array_equal(got.numpy()[0, 0], state[anc[0].numpy()])


@pytest.mark.parametrize("kind", ("multinomial", "residual"))
def test_step_kernel_mismatch_rate_over_seeds(kind, capsys):
    """Row 29 against ``prefix_pallas_step`` on eight bank rows of
    log-weights at N = 8192 (UNGM's and normal ones by turns), each row
    resampling, with the JAX draws: the
    ancestor mismatch rate of each row within ``MAX_MISMATCH_RATE``, and
    the rates printed (for residual a flipped ``floor(N·w)`` would move
    ``n_det`` and shift every later slot, a rate of a large share)."""
    n, rows = 8192, 8
    lw = np.stack([_log_weights(("ungm", "normal")[r % 2], n, seed=100 + r)
                   for r in range(rows)])
    state = np.random.default_rng(5).normal(size=(rows, 1, n)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(11), rows)
    ubase = np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in keys])
    tanc, _, tst = stk.prefix_step_rows(torch.from_numpy(lw), torch.from_numpy(state),
                                        torch.from_numpy(ubase), None, 1.0, kind)
    rates = []
    for r in range(rows):
        jk, _, jstats = prefix_pallas_step(_r2(lw[r]), jnp.asarray(state[r].reshape(1, -1, 128)),
                                           _r2(ubase[r]), jnp.zeros((1,)), jnp.float32([1.0]),
                                           kind=kind, interpret=True)
        rates.append(_check_step(tanc[r], tst[r], jk, jstats))
    with capsys.disabled():
        print(f"\n{kind} step kernel vs JAX over {rows} rows of N = {n}: ancestor mismatch "
              f"rates {[float(x) for x in rates]}")


def test_step_rows_kernel():
    """Each row its own trigger, a dead row on the uniform bank."""
    n = 2048
    lw = np.stack([_log_weights(k, n, seed=i) for i, k in enumerate(("normal", "ungm", "dead"))])
    state = torch.randn(3, 1, n, generator=torch.Generator().manual_seed(5))
    ubase = torch.rand(3, n, generator=torch.Generator().manual_seed(6))
    anc, out, st = stk.prefix_step_rows(torch.from_numpy(lw), state, ubase, None, 0.5,
                                        "multinomial")
    np.testing.assert_array_equal(st[:, 2].numpy(), [1.0, 1.0, 0.0])  # uniform: ESS = N
    for r in range(2):
        one = slice(r, r + 1)
        single = stk.prefix_step_rows(torch.from_numpy(lw[one]), state[one], ubase[one], None,
                                      0.5, "multinomial")
        assert torch.equal(single[0][0], anc[r])
    assert torch.equal(anc[2], torch.arange(n, dtype=torch.int32))
    assert torch.equal(out, torch.gather(state, 2, anc.long()[:, None]))


def _check_step(anc, stats, janc, jstats):
    jstats = np.asarray(jstats).reshape(stats.shape)
    stats = stats.numpy()
    np.testing.assert_array_equal(stats[..., 2], jstats[..., 2])  # same trigger
    np.testing.assert_allclose(stats[..., [0, 3]], jstats[..., [0, 3]], rtol=STATS_RTOL)
    np.testing.assert_allclose(stats[..., 1], jstats[..., 1], atol=INCR_ATOL, equal_nan=True)
    rate = (anc.numpy() != np.asarray(janc).reshape(anc.shape)).mean()
    assert rate <= MAX_MISMATCH_RATE
    return rate


def test_wrappers_on_cpu_count_no_launch():
    for module in (pk, sk, stk):
        module.reset_launch_counts()
    w = torch.rand(2, 2048)
    c = pk.prefix_sum_rows(w)
    sk.searchsorted_rows(c, w, "right")
    sk.searchsorted_gather_rows(c, w, w[:, None], "left")
    nd = torch.tensor([3, 4])
    sk.residual_select_gather_rows(c, c, w, nd, w[:, None])
    stk.prefix_step_rows(w[:1].log(), w[:1, None], w[:1], None, 0.5, "stratified")
    stk.prefix_step_rows(w.log(), w[:, None], None, w[:, 0], 0.5, "systematic")
    assert [fn.launches for fn in pk.WRAPPERS + sk.WRAPPERS + stk.WRAPPERS] == [0] * 5


@pytest.mark.parametrize("bad", ("n", "shape", "side", "kind", "u0"))
def test_wrappers_validate(bad):
    n = 1000 if bad == "n" else 2048
    w = torch.rand(2, n)
    u = torch.rand(3, n) if bad == "shape" else w
    with pytest.raises(ValueError):
        if bad in ("n", "shape", "side"):
            sk.searchsorted_rows(pk.prefix_sum_rows(w) if bad != "n" else w, u,
                                 "middle" if bad == "side" else "left")
        elif bad == "kind":
            stk.prefix_step_rows(w, w[:, None], w, None, 0.5, "multinomal")
        else:  # systematic takes u0, not ubase
            stk.prefix_step_rows(w, w[:, None], w, None, 0.5, "systematic")


def test_residual_above_2_24_raises():
    """Residual's counts are scanned and summed in f32, exact only up to
    N = 2**24; above it every residual entry raises before any work."""
    n = (1 << 24) + 1024
    w = torch.empty(1, n).expand(1, n)
    r = PrefixSumSpec(kind="residual").build()
    key = trandom.PRNGKey(0)
    with pytest.raises(ValueError, match="2\\*\\*24"):
        r(key, w[0])
    with pytest.raises(ValueError, match="2\\*\\*24"):
        r.step_rows(key[None], w, w, 0.5)
    with pytest.raises(ValueError, match="2\\*\\*24"):
        stk.check_kind("residual", "residual", n)
    stk.check_kind("residual", "residual", 1 << 24)


def test_bank_forms_launch_each_stage_once(monkeypatch):
    """A multinomial call at S = 1 and at S = 3: one scan and one search
    each, one population as a bank of one row (residual: three scans and two
    searches, or the select)."""
    calls = []

    def counted(name, fn):
        def wrapper(*args):
            calls.append(name)
            return fn(*args)
        return wrapper

    for name in ("prefix_sum_rows", "searchsorted_rows", "searchsorted_gather_rows",
                 "residual_select_gather_rows"):
        monkeypatch.setattr(pops, name, counted(name, getattr(pops, name)))
    key = trandom.PRNGKey(3)
    w = torch.rand(3, 2048)
    r = PrefixSumSpec(kind="multinomial").build()
    r(key, w[0])
    assert calls == ["prefix_sum_rows", "searchsorted_rows"]
    calls.clear()
    r.batch(key, w)
    assert calls == ["prefix_sum_rows", "searchsorted_rows"]
    calls.clear()
    PrefixSumSpec(kind="residual").build().batch_rows(trandom.split(key, 3), w)
    assert calls == ["prefix_sum_rows"] * 3 + ["searchsorted_rows"] * 2
    calls.clear()
    PrefixSumSpec(kind="residual").build().apply_batch(key, w, w)
    assert calls == ["prefix_sum_rows"] * 3 + ["residual_select_gather_rows"]


# ----------------------------------------------------------------- entry level
def _resamplers(kind):
    jr = JaxSpec(kind=kind, backend="pallas_interpret").build()
    return jr, convert.spec_from_jax(jr.spec).build()


def _keys(seed, rows=None):
    key = jax.random.PRNGKey(seed)
    if rows is not None:
        key = jax.random.split(key, rows)
    return key, convert.key_from_jax(jax.random.key_data(key))


#: Each entry at one N and on its weights, so that N in {2048, 8192} and
#: every weight case are crossed over the kinds.
ENTRY_CASES = {
    "__call__": (8192, ("zeros",)), "batch": (2048, ("gamma", "equal", "nan")),
    "batch_rows": (8192, ("subnormal", "dominant", "tiny_normal")),
    "apply": (2048, ("equal",)), "apply_batch": (8192, ("tiny_normal", "zeros", "gamma")),
    "apply_rows": (2048, ("dominant", "nan", "subnormal")),
}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("entry", tuple(ENTRY_CASES))
def test_entries_bits(kind, entry):
    n, wkinds = ENTRY_CASES[entry]
    jr, tr = _resamplers(kind)
    w = _bank(wkinds, n, seed=len(kind))
    if entry in ("__call__", "apply"):
        w = w[0]
    p = np.random.default_rng(10).normal(size=w.shape + (2,)).astype(np.float32)
    jkey, tkey = _keys(12, rows=3 if entry.endswith("_rows") else None)
    jargs, targs = [jkey, jnp.asarray(w)], [tkey, torch.from_numpy(w)]
    if entry.startswith("apply"):
        jargs.append(jnp.asarray(p))
        targs.append(torch.from_numpy(p))
    jfn = jr if entry == "__call__" else getattr(jr, entry)
    tfn = tr if entry == "__call__" else getattr(tr, entry)
    jout, tout = jfn(*jargs), tfn(*targs)
    if entry.startswith("apply"):
        np.testing.assert_array_equal(_bits(tout[0].numpy()), _bits(np.asarray(jout[0])))
        jout, tout = jout[1], tout[1]
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


def _stats_vec(st, axis):
    fields = ("ess_norm", "log_evidence_incr", "resampled", "max_weight")
    return np.stack([np.asarray(getattr(st, f)) for f in fields], axis)


@pytest.mark.parametrize("kind", KINDS)
def test_step_entry(kind, capsys):
    """``step`` from raw log-weights at N = 8192 (it resamples at 1.0)."""
    jr, tr = _resamplers(kind)
    lw = _log_weights("ungm", 8192, seed=13)
    p = np.random.default_rng(14).normal(size=8192).astype(np.float32)
    jkey, tkey = _keys(15)
    jp, ja, js_ = jr.step(jkey, jnp.asarray(lw), jnp.asarray(p), 1.0)
    tp, ta, ts = tr.step(tkey, torch.from_numpy(lw), torch.from_numpy(p), 1.0)
    rate = _check_step(ta, torch.from_numpy(_stats_vec(ts, 0)), ja, _stats_vec(js_, 0))
    with capsys.disabled():
        print(f"\n{kind} step vs JAX: ancestor mismatch rate {rate:.3g}")
    np.testing.assert_array_equal(tp.numpy(), p[ta.numpy()])


@pytest.mark.parametrize("kind", KINDS)
def test_step_rows_entry(kind):
    """Each row its own trigger at threshold 0.5, a dead row on the uniform
    bank."""
    jr, tr = _resamplers(kind)
    lws = np.stack([_log_weights(k, 2048, seed=i)
                    for i, k in enumerate(("normal", "ungm", "dead"))])
    ps = np.random.default_rng(16).normal(size=(3, 2048)).astype(np.float32)
    jkeys, tkeys = _keys(17, rows=3)
    jp, ja, js_ = jr.step_rows(jkeys, jnp.asarray(lws), jnp.asarray(ps), 0.5)
    tp, ta, ts = tr.step_rows(tkeys, torch.from_numpy(lws), torch.from_numpy(ps), 0.5)
    _check_step(ta, torch.from_numpy(_stats_vec(ts, -1)), ja, _stats_vec(js_, -1))
    np.testing.assert_array_equal(ts.degenerate.numpy(), np.asarray(js_.degenerate))


@pytest.mark.parametrize("kind", KINDS)
def test_step_on_reference_weights_equals_apply(kind):
    """The resample branch of the JAX step, fed through the port's apply
    with the weights JAX normalised, is bit-identical."""
    jr, tr = _resamplers(kind)
    lw = _log_weights("ungm", 2048, seed=18)
    p = np.random.default_rng(19).normal(size=2048).astype(np.float32)
    jkey, tkey = _keys(20)
    jp, ja, js_ = jr.step(jkey, jnp.asarray(lw), jnp.asarray(p), 1.0)
    assert float(js_.resampled) == 1.0
    w_ref = np.array(jax.jit(jax_normalise)(jnp.asarray(lw)))
    tp, ta = tr.apply(tkey, torch.from_numpy(w_ref), torch.from_numpy(p))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(_bits(tp.numpy()), _bits(np.asarray(jp)))


def test_improved_systematic_is_systematic():
    _, key = _keys(21)
    w = torch.from_numpy(_weights("gamma", 2048))
    assert torch.equal(PrefixSumSpec(kind="improved_systematic").build()(key, w),
                       PrefixSumSpec(kind="systematic").build()(key, w))


def test_draws_follow_kind_draws():
    """The port's draws of the four draw formulas against the JAX
    package's ``kind_draws`` at N = 3072 (``total / N`` by a constant that
    is not a power of two: XLA takes it as ``total·fl(1/N)``)."""
    from repro.kernels.prefix_sum.ops import kind_draws as jax_kind_draws

    n, total = 3072, np.float32(1234.567)
    jkey, tkey = _keys(22)
    for kind in ("multinomial", "systematic", "improved_systematic", "stratified"):
        ju, jside = jax_kind_draws(jkey, n, jnp.float32(total), jnp.float32, kind)
        tu, tside = pops.kind_draws(tkey[None], n, torch.tensor([total]), kind)
        assert tside == jside
        np.testing.assert_array_equal(_bits(tu[0].numpy()), _bits(np.asarray(ju)))


def test_bank_contracts():
    s, n = 3, 2048
    r = PrefixSumSpec(kind="stratified").build()
    _, key = _keys(30)
    keys = trandom.split(key, s)
    w = torch.from_numpy(_weights("gamma", (s, n), seed=31))
    p = torch.randn(s, n, generator=torch.Generator().manual_seed(2))
    singles = torch.stack([r(keys[i], w[i]) for i in range(s)])
    assert torch.equal(r.batch_rows(keys, w), singles)
    assert torch.equal(r.batch(key, w), singles)  # split(key, S) == keys here
    prow, arow = r.apply_rows(keys, w, p)
    assert torch.equal(arow, singles) and torch.equal(prow, torch.gather(p, 1, singles.long()))
    assert torch.equal(r.apply_batch(key, w, p)[1], singles)
    _, sanc, _ = r.step_rows(keys, w.log(), p, 1.0)
    assert torch.equal(sanc[2], r.step(keys[2], w[2].log(), p[2], 1.0)[1])


# --------------------------------------------------------- spec and convert
@pytest.mark.parametrize("field,value,err", (
    ("kind", "multinomal", ValueError),
    ("kind", "bogus", ValueError),
    ("backend", "reference", None),
    ("backend", "pallas", ValueError),
    ("backend", "tpu", ValueError),
    ("plane_dtype", "float8_e4m3fn", ValueError),
    ("plane_dtype", "float64", ValueError),
    ("guard", "flag", None),
    ("guard", "loud", ValueError),
))
def test_spec_validates(field, value, err):
    if err is None:  # the reference backend and the guard build
        _builds_and_runs(PrefixSumSpec(**{field: value}), field, value)
        return
    with pytest.raises(err):
        PrefixSumSpec(**{field: value})


def _builds_and_runs(spec, field, value):
    """A spec that validates builds, and its entry runs on the CPU."""
    r = spec.build()
    assert getattr(r.spec, field) == value
    anc = r(torch.zeros(2, dtype=torch.int64), torch.full((2048,), 1.0 / 2048))
    assert anc.shape == (2048,) and anc.dtype == torch.int32


def test_spec_names_its_kind():
    with pytest.raises(ValueError, match="did you mean 'multinomial'"):
        PrefixSumSpec(kind="multinomal")
    for kind in KINDS:
        spec = PrefixSumSpec(kind=kind)
        assert spec.name == kind and spec.build().name == kind
    assert PrefixSumSpec().kind == "systematic" and PrefixSumSpec().backend == "cuda"
    assert not hasattr(PrefixSumSpec(), "num_iters")


@pytest.mark.parametrize("kind", KINDS)
def test_convert_spec_round_trip(kind):
    spec = convert.spec_from_jax(JaxSpec(kind=kind, backend="pallas"))
    assert spec == PrefixSumSpec(kind=kind)
    back = JaxSpec(**convert.spec_to_jax(spec))
    assert back == JaxSpec(kind=kind, backend="pallas")
    assert convert.spec_from_jax(back) == spec
    assert convert.spec_from_jax(JaxSpec(kind=kind)) == \
        PrefixSumSpec(kind=kind, backend="reference")


# ---------------------------------------------------------------- the filter
N, T = 4096, 10


@pytest.fixture(scope="module")
def sim():
    key = jax.random.PRNGKey(1)
    xs, zs = jf.simulate(key, jm.ungm(), T)
    return key, np.array(xs), np.array(zs)


def _tkey(key):
    return convert.key_from_jax(jax.random.key_data(key))


@pytest.mark.parametrize("kind", ("multinomial", "residual"))
def test_replay_alg6_bits(sim, kind):
    """The JAX Alg. 6 filter step by step; its pre-resample particles,
    weights and resample key go through the port's fused resample stage,
    which must return the same particles and ancestors bit for bit."""
    _, _, zs = sim
    model = jm.ungm()
    jpf = jf.ParticleFilter(model, N, resampler=JaxSpec(kind=kind, backend="pallas_interpret"))
    tpf = tf.ParticleFilter(tm.ungm(), N, resampler=PrefixSumSpec(kind=kind))
    stage1 = jax.jit(lambda k, x, z, t: (lambda y: (y, model.likelihood(z, y, t)))(
        model.transition(k, x, t)))
    k0, k = jax.random.split(jax.random.PRNGKey(6))
    particles = model.init(k0, N)
    flushed = 0
    for t in range(1, T + 1):
        k, ks = jax.random.split(k)
        k_pred, k_res = jax.random.split(ks)
        x, w = stage1(k_pred, particles, zs[t - 1], jnp.float32(t))
        jx, ja = jpf._built.apply(k_res, w, x)
        tx, ta = tpf._built.apply(_tkey(k_res), convert.array_from_jax(w, device="cpu"),
                                  convert.array_from_jax(x, device="cpu"))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja), err_msg=f"step {t}")
        np.testing.assert_array_equal(_bits(tx.numpy()), _bits(jx), err_msg=f"step {t}")
        flushed += int((np.asarray(w) == 0).sum())
        particles = jx
    assert flushed > 0  # the run reaches likelihoods XLA flushes to zero


def _jax_ungm():
    """UNGM with the JAX package's arithmetic: the port's filter loop and
    resampler over the same bits of noise and likelihood as the JAX run
    (the port's own noise is within 3 ULP of JAX's, its ``exp`` within 1)."""
    m = jm.ungm()
    transition, likelihood = jax.jit(m.transition), jax.jit(m.likelihood)

    def to_t(a):
        return torch.from_numpy(np.array(a))

    return tf.StateSpaceModel(
        transition=lambda key, x, t: to_t(transition(convert.key_to_jax(key), x.numpy(),
                                                     np.float32(t))),
        observe=None,
        likelihood=lambda z, x, t: to_t(likelihood(np.float32(z), x.numpy(), np.float32(t))),
        init=lambda key, n, device: to_t(m.init(convert.key_to_jax(key), n)),
        name="ungm_jax")


@pytest.mark.parametrize("kind", ("multinomial", "residual"))
def test_whole_run_on_jax_arithmetic(sim, kind):
    """A whole Alg. 6 run of the port's filter on the JAX model's arithmetic
    against the JAX filter: the resampled particles are the same bits at
    every step, so the estimates differ only by the order of the mean's
    sum."""
    key, _, zs = sim
    jpf = jf.ParticleFilter(jm.ungm(), N, resampler=JaxSpec(kind=kind, backend="pallas_interpret"))
    tpf = tf.ParticleFilter(_jax_ungm(), N, resampler=PrefixSumSpec(kind=kind))
    jest = np.asarray(jf.run_filter(key, jpf, jnp.asarray(zs)))
    test = tf.run_filter(_tkey(key), tpf, torch.from_numpy(zs), device="cpu").numpy()
    np.testing.assert_allclose(test, jest, rtol=1e-5, atol=1e-5)


def _rmse(est, ref) -> np.ndarray:
    return np.sqrt(np.mean((np.asarray(est) - ref) ** 2, axis=-1))


@pytest.mark.parametrize("kind", ("multinomial", "residual"))
@pytest.mark.parametrize("entry", ("run_filter", "run_filter_bank"))
def test_run_filter_matches(sim, kind, entry, capsys):
    """Conditional runs (threshold 0.5) on the port's own UNGM against
    JAX's: one filter, and a bank of 2 (two simulated streams).  The runs'
    RMSE against the truth behind each stream (paper eq. 24) agree within
    ``WHOLE_RUN_ATOL``.  Step
    by step the estimates can drift further for a CDF resampler: each
    weight's ULP moves every later CDF value, so a draw within a few ULP of
    a CDF step flips, and UNGM carries the flipped particle on (multinomial,
    one filter: 0.26 at step 10 here; the printed gap)."""
    key, xs, zs = sim
    jspec = JaxSpec(kind=kind, backend="pallas_interpret")
    jpf = jf.ParticleFilter(jm.ungm(), N, resampler=jspec, ess_threshold=0.5)
    tpf = tf.ParticleFilter(tm.ungm(), N, resampler=convert.spec_from_jax(jspec),
                            ess_threshold=0.5)
    obs, truth = zs, xs
    if entry == "run_filter_bank":
        xs2, zs2 = (np.array(a) for a in jf.simulate(jax.random.PRNGKey(2), jm.ungm(), 6))
        obs, truth = np.stack([zs[:6], zs2]), np.stack([xs[:6], xs2])
    jest = getattr(jf, entry)(key, jpf, jnp.asarray(obs))
    test = getattr(tf, entry)(_tkey(key), tpf, torch.from_numpy(obs), device="cpu")
    assert test.shape == obs.shape and torch.isfinite(test).all()
    gap = np.abs(_rmse(test.numpy(), truth) - _rmse(jest, truth))
    with capsys.disabled():
        step_gap = float(np.abs(test.numpy() - np.asarray(jest)).max())
        print(f"\n{kind} {entry} (threshold 0.5) vs JAX: RMSE gap {gap.max():.3g}, "
              f"max |estimate gap| {step_gap:.3g}")
    assert (gap <= WHOLE_RUN_ATOL).all()


def test_particle_filter_takes_every_kind():
    for kind in KINDS:
        pf = tf.ParticleFilter(tm.ungm(), N, resampler=PrefixSumSpec(kind=kind))
        assert pf.spec == PrefixSumSpec(kind=kind)
