"""The port's rejection kernels (Murray's baseline, paper §1; plain versions
on the CPU) against the JAX package's Pallas kernels in interpret mode, at
kernel, entry and filter level.

* Index-only and ``apply`` forms take linear weights: ancestors and states
  must match bit for bit, with the cap binding (``max_iters`` 1, and 64 on
  eq. (12) weights at y = 4), subnormal and tiny-normal weights, and a NaN
  row (no lane accepts; every lane keeps its own index).
* ``step`` from raw log-weights: torch's ``exp`` is 1 ULP off XLA's on some
  inputs and the stats' sums run in another order, so the stats are held to
  ``STATS_RTOL``/``INCR_ATOL`` and the ancestors to a mismatch rate of at
  most ``MAX_MISMATCH_RATE``, the bounds of ``test_torch_metropolis.py``;
  fed the weights JAX normalised, the port's ``apply`` equals JAX's step
  bit for bit.
* Filters: the Alg. 6 replay bit for bit; whole runs within
  ``WHOLE_RUN_ATOL``, the bound of ``test_torch_pf.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.metrics import normalise_log_weights as jax_normalise
from repro.core.spec import RejectionSpec as JaxSpec
from repro.kernels.rejection import rejection as jk
from repro.pf import filter as jf
from repro.pf import models as jm
from repro_torch import convert
from repro_torch import random as trandom
from repro_torch.core import spec as tspec
from repro_torch.core.spec import RejectionSpec
from repro_torch.core.weightgen import gaussian_weights
from repro_torch.kernels.common import flush_to_zero
from repro_torch.kernels.metropolis.ref import accept_uniform, proposal_index
from repro_torch.kernels.rejection import ops as rops
from repro_torch.kernels.rejection import ref
from repro_torch.kernels.rejection import rejection as rk
from repro_torch.pf import filter as tf
from repro_torch.pf import models as tm

STATS_RTOL = 2e-6
INCR_ATOL = 2e-6
MAX_MISMATCH_RATE = 1e-3
WHOLE_RUN_ATOL = 0.05


@pytest.fixture(autouse=True)
def _partitionable():
    assert jax.config.jax_threefry_partitionable


def _weights(kind: str, shape, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "gamma":
        return rng.gamma(0.5, size=shape).astype(np.float32)
    if kind == "subnormal":
        w = np.exp(-0.5 * rng.uniform(0, 14, size=shape) ** 2).astype(np.float32)
        w[..., ::7] = np.float32(1e-39)
        return w
    if kind == "tiny_normal":
        return (rng.uniform(1.0, 4.0, size=shape) * 1.5e-38).astype(np.float32)
    if kind == "nan":
        w = rng.gamma(0.5, size=shape).astype(np.float32)
        w[..., 5] = np.nan
        return w
    if kind == "heavy":  # eq. (12) at y = 4: sup w / mean w in the hundreds
        key = trandom.fold_in(trandom.PRNGKey(seed), 4)
        return gaussian_weights(key, int(np.prod(shape)), 4.0, device="cpu").numpy().reshape(shape)
    raise ValueError(kind)


def _log_weights(kind, shape, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return (rng.normal(size=shape) * 3).astype(np.float32)
    if kind == "ungm":
        return (-0.5 * rng.uniform(0, 12, size=shape) ** 2).astype(np.float32)
    if kind == "dead":
        return np.full(shape, -np.inf, np.float32)
    raise ValueError(kind)


def _seeds(rows, seed=0):
    rng = np.random.default_rng(seed + 100)
    return rng.integers(0, 2**32, size=rows, dtype=np.uint64).astype(np.uint32)


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.int32)


def _t(seeds) -> torch.Tensor:
    return torch.from_numpy(seeds.astype(np.int64))


def _check_step(anc, stats, janc, jstats):
    jstats = np.asarray(jstats).reshape(stats.shape)
    stats = stats.numpy()
    np.testing.assert_array_equal(stats[..., 2], jstats[..., 2])  # same trigger
    np.testing.assert_allclose(stats[..., [0, 3]], jstats[..., [0, 3]], rtol=STATS_RTOL)
    np.testing.assert_allclose(stats[..., 1], jstats[..., 1], atol=INCR_ATOL, equal_nan=True)
    rate = (anc.numpy() != np.asarray(janc).reshape(anc.shape)).mean()
    assert rate <= MAX_MISMATCH_RATE


# ---------------------------------------------------------------- kernel level
KERNEL_CASES = (("gamma", 1024, 1), ("gamma", 8192, 1024), ("subnormal", 3072, 24),
                ("subnormal", 8192, 1), ("tiny_normal", 8192, 24), ("nan", 1024, 24),
                ("heavy", 8192, 64), ("heavy", 3072, 1024))


@pytest.mark.parametrize("kind,n,max_iters", KERNEL_CASES)
def test_kernel_bits(kind, n, max_iters):
    """Rows 19 and 21: index-only and fused, one population; the rounds of
    the plain version say how often the cap bound."""
    w = _weights(kind, n)
    state = np.random.default_rng(2).normal(size=n).astype(np.float32)
    seeds = _seeds(1)
    w2 = jnp.asarray(w.reshape(-1, 128))
    janc = jk.rejection_pallas(w2, jnp.asarray(seeds), max_iters=max_iters, interpret=True)
    jfanc, jout = jk.rejection_pallas_fused(w2, jnp.asarray(state.reshape(1, -1, 128)),
                                            jnp.asarray(seeds), max_iters=max_iters,
                                            interpret=True)
    seed = torch.tensor(int(seeds[0]))
    anc = rk.rejection(torch.from_numpy(w), seed, max_iters)
    fanc, got = rk.rejection_fused(torch.from_numpy(w), torch.from_numpy(state)[None], seed,
                                   max_iters)
    np.testing.assert_array_equal(anc.numpy(), np.asarray(janc).reshape(n))
    np.testing.assert_array_equal(fanc.numpy(), anc.numpy())
    np.testing.assert_array_equal(_bits(got.numpy()[0]), _bits(np.asarray(jout).reshape(n)))
    rounds = ref.rejection_rounds_ref(torch.from_numpy(w)[None], seed.reshape(1), max_iters)
    capped = float((rounds == max_iters).float().mean())
    if kind == "nan":
        assert capped == 1.0 and torch.equal(anc, torch.arange(n, dtype=torch.int32))
    elif max_iters == 1 or (kind, max_iters) == ("heavy", 64):
        assert capped > 0.01  # the cap binds: those lanes keep their own index
    elif kind == "gamma":
        assert capped == 0.0


@pytest.mark.parametrize("n", (3072, 8192))
def test_bank_kernels_are_rows_of_single(n):
    """Rows 20 and 22: the bank kernels against JAX's, and each row the
    single JAX kernel with that row's seed."""
    s, max_iters = 3, 24
    w = _weights("subnormal", (s, n), seed=1)
    state = np.random.default_rng(3).normal(size=(s, 2, n)).astype(np.float32)
    seeds = _seeds(s, seed=1)
    w3 = jnp.asarray(w.reshape(s, -1, 128))
    janc = jk.rejection_pallas_batch(w3, jnp.asarray(seeds), max_iters=max_iters,
                                     interpret=True)
    jfanc, jout = jk.rejection_pallas_fused_batch(
        w3, jnp.asarray(state.reshape(s, 2, -1, 128)), jnp.asarray(seeds), max_iters=max_iters,
        interpret=True)
    anc = rk.rejection_batch(torch.from_numpy(w), _t(seeds), max_iters)
    fanc, got = rk.rejection_fused_batch(torch.from_numpy(w), torch.from_numpy(state),
                                         _t(seeds), max_iters)
    np.testing.assert_array_equal(anc.numpy(), np.asarray(janc).reshape(s, n))
    np.testing.assert_array_equal(fanc.numpy(), anc.numpy())
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(np.asarray(jout).reshape(s, 2, n)))
    for r in range(s):
        one = jk.rejection_pallas(jnp.asarray(w[r].reshape(-1, 128)), jnp.asarray(seeds[r:r + 1]),
                                  max_iters=max_iters, interpret=True)
        np.testing.assert_array_equal(anc[r].numpy(), np.asarray(one).reshape(n))


@pytest.mark.parametrize("kind", ("normal", "ungm", "dead"))
@pytest.mark.parametrize("thr", (0.0, 0.5, 1.0))
def test_step_kernel(kind, thr):
    """Row 23."""
    n, max_iters = 4096, 24
    lw = _log_weights(kind, n)
    state = np.random.default_rng(4).normal(size=n).astype(np.float32)
    seeds = _seeds(1, seed=2)
    k2, out, stats = jk.rejection_pallas_step(
        jnp.asarray(lw.reshape(-1, 128)), jnp.asarray(state.reshape(1, -1, 128)),
        jnp.asarray(seeds), jnp.float32([thr]), max_iters=max_iters, interpret=True)
    anc, got, st = rk.rejection_step(torch.from_numpy(lw), torch.from_numpy(state)[None],
                                     torch.tensor(int(seeds[0])), max_iters, thr)
    _check_step(anc, st, k2, stats)
    np.testing.assert_array_equal(got.numpy()[0], state[anc.numpy()])


def test_step_rows_kernel():
    """Row 24: each row its own trigger, a dead row on the uniform bank."""
    n, max_iters = 3072, 1024
    lw = np.stack([_log_weights(k, n, seed=i) for i, k in enumerate(("normal", "ungm", "dead"))])
    state = np.random.default_rng(5).normal(size=(3, 1, n)).astype(np.float32)
    seeds = _seeds(3, seed=3)
    k3, out, stats = jk.rejection_pallas_step_rows(
        jnp.asarray(lw.reshape(3, -1, 128)), jnp.asarray(state.reshape(3, 1, -1, 128)),
        jnp.asarray(seeds), jnp.float32([0.5]), max_iters=max_iters, interpret=True)
    anc, got, st = rk.rejection_step_rows(torch.from_numpy(lw), torch.from_numpy(state),
                                          _t(seeds), max_iters, 0.5)
    _check_step(anc, st, k3, stats)
    np.testing.assert_array_equal(st[:, 2].numpy(), [1.0, 1.0, 0.0])  # uniform: ESS = N
    np.testing.assert_array_equal(got.numpy(), np.take_along_axis(state, anc.numpy()[:, None], 2))


def test_ref_step_is_the_chain_on_normalised_weights():
    """The plain step's resample branch is the plain fused chain on
    exp(lw - m) (1/N on a dead row); its sup w, the literal max, is 1 on a
    live row and 1/N on a dead one, as the kernel takes it."""
    n, max_iters = 3072, 64
    lw = torch.from_numpy(np.stack([_log_weights("normal", n, seed=27),
                                    _log_weights("dead", n)]))
    state = torch.randn(2, 1, n, generator=torch.Generator().manual_seed(1))
    seeds = torch.tensor([5, 2**32 - 3])
    anc, out, stats = ref.rejection_step_rows_ref(lw, state, seeds, max_iters, 1.0)
    w = torch.exp(lw[:1] - lw[:1].amax(dim=1, keepdim=True))
    w = torch.cat([w, torch.full((1, n), 1.0 / n)])
    assert w.amax(dim=1).tolist() == [1.0, np.float32(1.0 / n)]
    anc2, out2 = ref.rejection_rows_ref(w, state, seeds, max_iters)
    assert torch.equal(anc, anc2) and torch.equal(out, out2)
    assert torch.equal(ref.rejection_rows_ref(w, None, seeds, max_iters), anc2)
    assert stats[:, 2].eq(1).all()
    rounds = ref.rejection_rounds_ref(lw, seeds, max_iters, log_weights=True, thr=1.0)
    assert torch.equal(rounds, ref.rejection_rounds_ref(w, seeds, max_iters))
    assert ref.rejection_rounds_ref(lw, seeds, max_iters, log_weights=True, thr=0.0).eq(-1).all()


@pytest.mark.parametrize("kind,max_iters", (("gamma", 1024), ("heavy", 64), ("gamma", 1)))
def test_rounds_explain_the_ancestors(kind, max_iters):
    """``rejection_rounds_ref`` against the ancestors it explains: a lane
    that accepted at round 0 keeps its index; at round r > 0 its ancestor
    is round r's proposal, which passes the accept test, and the lane's
    earlier proposals fail it; a lane at the cap that never accepted keeps
    its index."""
    n = 4096
    w = torch.from_numpy(_weights(kind, (2, n), seed=8))
    seeds = torch.tensor([7, 2**31 + 11])
    anc = rk.rejection_batch(w, seeds, max_iters).long()
    rounds = ref.rejection_rounds_ref(w, seeds, max_iters)
    i = torch.arange(n).expand(2, n)
    sd = seeds.unsqueeze(1)
    w_max = w.amax(dim=1, keepdim=True)

    def accepts(b, j):
        return flush_to_zero(accept_uniform(sd, i, n, b) * w_max) <= torch.gather(w, 1, j)

    assert torch.equal(anc[rounds == 0], i[rounds == 0])
    assert (accepts(0, i) == (rounds == 0)).all()
    pending = rounds > 0
    for b in range(1, max_iters + 1):
        j = proposal_index(sd, i, n, b)
        hit = accepts(b, j)
        at_b = pending & hit
        assert torch.equal(rounds[at_b], torch.full_like(rounds[at_b], b))
        assert torch.equal(anc[at_b], j[at_b])
        pending &= ~hit
    assert (rounds[pending] == max_iters).all() and torch.equal(anc[pending], i[pending])
    if kind == "gamma" and max_iters == 1024:
        assert not pending.any()
    else:
        assert pending.any()


#: Particles a warp takes at a time, at least (``REJ_CHUNK`` in
#: ``csrc/rejection.cu``).
REJ_CHUNK = 64


def _warp_pieces(rows: int, n: int, warps: int, w: int, rng) -> list:
    """``warp_chains``' hand-out of particles to warp ``w`` of ``warps``
    (``csrc/rejection.cu``), as a transcript: the turn's pieces, the rows
    and particles the idle lanes take (``take`` at a time, a number of idle
    lanes drawn from ``rng``), and the move to the warp's piece of the next
    turn.  Returns the ids ``s·N + i`` in the order the warp takes them."""
    total = rows * n
    pieces = warps * max(1, total // (warps * REJ_CHUNK))
    piece = w
    cur, end = total * piece // pieces, total * (piece + 1) // pieces
    cr, ci = divmod(cur, n)
    ids = []
    while cur < end:
        take = min(int(rng.integers(1, 33)), end - cur)
        for rank in range(take):
            nxt = ci + rank >= n
            assert ci + rank < n + 32  # this row or the next
            s, i = cr + nxt, ci + rank - (n if nxt else 0)
            assert s * n + i == cur + rank
            ids.append(s * n + i)
        cur += take
        ci += take
        if ci >= n:
            ci -= n
            cr += 1
        if cur == end and piece + warps < pieces:
            piece += warps
            cur, end = total * piece // pieces, total * (piece + 1) // pieces
            cr, ci = divmod(cur, n)
    return ids


@pytest.mark.parametrize("rows,n,warps", ((1, 1024, 3), (3, 3072, 5), (16, 1024, 7),
                                          (2, 2048, 40), (1, 1024, 2000)))
def test_warp_chains_hand_out_every_particle_once(rows, n, warps):
    """The rejection kernels' warps (``warp_chains``) take pieces of the
    bank in turns: over all warps every particle id is taken once, whatever
    the idle lanes, on banks whose particles split unevenly over warps x
    ``REJ_CHUNK`` and on grids with more warps than particles (empty
    pieces); each warp's ids rise, so the grid sweeps the bank in order."""
    rng = np.random.default_rng(rows * n + warps)
    taken = []
    for w in range(warps):
        ids = _warp_pieces(rows, n, warps, w, rng)
        assert ids == sorted(ids)
        taken += ids
    assert sorted(taken) == list(range(rows * n))


def _nth_set(m: int, g: int) -> int:
    """``nth_set`` of ``csrc/rejection.cu``: the position of the set bit of
    rank g in m, by its binary search."""
    pos = 0
    for b in (16, 8, 4, 2, 1):
        if bin(m & ((1 << (pos + b)) - 1)).count("1") <= g:
            pos += b
    return pos


@pytest.mark.parametrize("busy", (16, 11, 5, 3, 1))
@pytest.mark.parametrize("max_iters", (24, 1024))
def test_warp_chains_spread_finds_the_first_accept(busy, max_iters):
    """``warp_chains``' last phase as a transcript: at most 16 particles
    left, each spread over 32 / 2^ceil(log2 busy) lanes, one round a lane
    (the rounds left to it, ``max_iters - t``, bound the lanes that run);
    the lowest set bit of a particle's lanes in the ballot is its first
    accept, so the rounds and ancestors are those of the sequential chain
    (``rejection_rounds_ref``, ``rejection_rows_ref``) as the group sizes
    change with the particles left."""
    n = 1024
    w = torch.from_numpy(_weights("heavy", (1, n), seed=busy))
    seeds = torch.tensor([2**31 + busy])
    rounds = ref.rejection_rounds_ref(w, seeds, max_iters)[0]
    anc = ref.rejection_rows_ref(w, None, seeds, max_iters)[0].long()
    # The particles with the longest chains, each from round 0, on lanes
    # drawn at random; each round's proposal and accept test.
    parts = torch.argsort(rounds, descending=True, stable=True)[:busy]
    scale = flush_to_zero(w.amax() * (1.0 / (1 << 24)))
    props, accs = [], []
    for b in range(max_iters + 1):
        j = parts if b == 0 else proposal_index(seeds, parts, n, b)
        props.append(j)
        accs.append(ref.scaled_uniform(seeds, parts, n, b, scale) <= flush_to_zero(w[0, j]))
    props, accs = torch.stack(props, 1).tolist(), torch.stack(accs, 1).tolist()
    lanes = sorted(np.random.default_rng(busy).choice(32, busy, replace=False).tolist())
    t = dict.fromkeys(range(busy), 0)  # particle (by its lane's index) -> next round
    got = {}
    while t:
        live = sorted(t)
        busy_mask = sum(1 << lanes[q] for q in live)
        nb = len(live)
        gsz = 32 >> (nb - 1).bit_length()
        hit = 0
        for lane in range(32):
            g = lane // gsz
            src = lanes.index(_nth_set(busy_mask, min(g, nb - 1)))
            o = lane % gsz
            if g < nb and o <= max_iters - t[src] and accs[src][t[src] + o]:
                hit |= 1 << lane
        for q in live:
            r = bin(busy_mask & ((1 << lanes[q]) - 1)).count("1")
            mine = (hit >> (r * gsz)) & ((1 << gsz) - 1)
            if mine:
                b = t[q] + (mine & -mine).bit_length() - 1
                got[q] = (b, props[q][b])
            elif max_iters - t[q] < gsz:
                got[q] = (max_iters, int(parts[q]))
            else:
                t[q] += gsz
                continue
            del t[q]
    for q, p in enumerate(parts.tolist()):
        assert got[q] == (int(rounds[p]), int(anc[p]))
    if max_iters == 1024:
        assert int(rounds[parts[0]]) > 32  # the spread runs more than one turn


def test_wrappers_on_cpu_count_no_launch():
    rk.reset_launch_counts()
    n = 4096
    w = torch.rand(2, n)
    seeds = torch.tensor([1, 2])
    rk.rejection(w[0], torch.tensor(3), 8)
    rk.rejection_batch(w, seeds, 8)
    rk.rejection_fused(w[0], w[:1], torch.tensor(3), 8)
    rk.rejection_fused_batch(w, w[:, None], seeds, 8)
    rk.rejection_step(w[0].log(), w[:1], torch.tensor(3), 8, 0.5)
    rk.rejection_step_rows(w.log(), w[:, None], seeds, 8, 0.5)
    assert [fn.launches for fn in rk.WRAPPERS] == [0] * 6


@pytest.mark.parametrize("bad", ("n", "seeds", "iters0", "iters_bool", "iters_float"))
def test_wrappers_validate(bad):
    n = 1000 if bad == "n" else 4096
    w = torch.rand(2, n)
    seeds = torch.tensor([1, 2, 3]) if bad == "seeds" else torch.tensor([1, 2])
    max_iters = {"iters0": 0, "iters_bool": True, "iters_float": 8.0}.get(bad, 8)
    with pytest.raises(ValueError):
        rk.rejection_fused_batch(w, w[:, None], seeds, max_iters)
    with pytest.raises(ValueError):
        rk.rejection_step_rows(w, w[:, None], seeds, max_iters, 0.5)


@pytest.mark.parametrize("step", (False, True))
def test_max_iters_caps(step):
    """Every wrapper, rows and step, takes ``max_iters`` up to 2^31 - 2, as
    the JAX loop does (rounds 0 .. max_iters count in an int; the kernels
    count the rounds left down, so no sum passes the cap); one more is
    refused.  Flat weights accept at round 0, so the cap costs no round."""
    w = torch.ones(2, 1024)
    seeds = torch.tensor([1, 2])
    if step:
        def call(m):
            return rk.rejection_step_rows(w.log(), w[:, None], seeds, m, 2.0)
    else:
        def call(m):
            return rk.rejection_fused_batch(w, w[:, None], seeds, m)
    cap = rk.MAX_ITERS
    assert cap == (1 << 31) - 2
    assert torch.equal(call(cap)[0], torch.arange(1024, dtype=torch.int32).expand(2, 1024))
    with pytest.raises(ValueError, match=f"max_iters must be an int in \\[1, {cap}\\]"):
        call(cap + 1)


# ----------------------------------------------------------------- entry level
def _resamplers(max_iters):
    jr = JaxSpec(max_iters=max_iters, backend="pallas_interpret").build()
    return jr, convert.spec_from_jax(jr.spec).build()


def _keys(seed, rows=None):
    key = jax.random.PRNGKey(seed)
    if rows is not None:
        key = jax.random.split(key, rows)
    return key, convert.key_from_jax(jax.random.key_data(key))


#: Each entry at one of the shapes, so that N in {1024, 3072, 8192} and
#: max_iters in {1, 24, 1024} are all crossed.
ENTRY_SHAPES = {"__call__": (3072, 1024), "batch": (1024, 24), "batch_rows": (8192, 1),
                "apply": (8192, 24), "apply_batch": (3072, 1), "apply_rows": (1024, 1024)}


@pytest.mark.parametrize("entry", tuple(ENTRY_SHAPES))
def test_entries_bits(entry):
    s = 3
    n, max_iters = ENTRY_SHAPES[entry]
    jr, tr = _resamplers(max_iters)
    bank = entry not in ("__call__", "apply")
    w = _weights("subnormal" if max_iters > 1 else "gamma", (s, n) if bank else n, seed=9)
    p = np.random.default_rng(10).normal(size=w.shape + (2,)).astype(np.float32)
    jkey, tkey = _keys(12, rows=s if entry.endswith("_rows") else None)
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


@pytest.mark.parametrize("thr", (0.0, 0.5, 1.0))
def test_step_entry(thr):
    jr, tr = _resamplers(1024)
    lw = _log_weights("ungm", 8192, seed=13)
    p = np.random.default_rng(14).normal(size=8192).astype(np.float32)
    jkey, tkey = _keys(15)
    jp, ja, js = jr.step(jkey, jnp.asarray(lw), jnp.asarray(p), thr)
    tp, ta, ts = tr.step(tkey, torch.from_numpy(lw), torch.from_numpy(p), thr)
    _check_step(ta, torch.from_numpy(_stats_vec(ts, 0)), ja, _stats_vec(js, 0))
    np.testing.assert_array_equal(tp.numpy(), p[ta.numpy()])
    assert bool(ts.degenerate) == bool(js.degenerate)


def test_step_rows_entry():
    """Each row its own trigger at threshold 0.5, a dead row on the uniform
    bank."""
    jr, tr = _resamplers(24)
    lws = np.stack([_log_weights(k, 3072, seed=i)
                    for i, k in enumerate(("normal", "ungm", "dead"))])
    ps = np.random.default_rng(16).normal(size=(3, 3072)).astype(np.float32)
    jkeys, tkeys = _keys(17, rows=3)
    jp, ja, js = jr.step_rows(jkeys, jnp.asarray(lws), jnp.asarray(ps), 0.5)
    tp, ta, ts = tr.step_rows(tkeys, torch.from_numpy(lws), torch.from_numpy(ps), 0.5)
    _check_step(ta, torch.from_numpy(_stats_vec(ts, -1)), ja, _stats_vec(js, -1))
    np.testing.assert_array_equal(ts.degenerate.numpy(), np.asarray(js.degenerate))


def test_step_on_reference_weights_equals_apply():
    """The resample branch of the JAX step, fed through the port's apply
    with the weights JAX normalised, is bit-identical."""
    jr, tr = _resamplers(1024)
    lw = _log_weights("ungm", 4096, seed=18)
    p = np.random.default_rng(19).normal(size=4096).astype(np.float32)
    jkey, tkey = _keys(20)
    jp, ja, js = jr.step(jkey, jnp.asarray(lw), jnp.asarray(p), 1.0)
    assert float(js.resampled) == 1.0
    w_ref = np.array(jax.jit(jax_normalise)(jnp.asarray(lw)))
    tp, ta = tr.apply(tkey, torch.from_numpy(w_ref), torch.from_numpy(p))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(_bits(tp.numpy()), _bits(np.asarray(jp)))


def test_bank_contracts():
    """Split-key contract: ``batch``/``apply_batch`` row ``s`` is the single
    call with ``split(key, S)[s]``; explicit keys: ``batch_rows``/
    ``apply_rows`` row ``s`` is the single call with ``keys[s]``; the step's
    rows likewise."""
    s, n = 4, 4096
    r = RejectionSpec(max_iters=64).build()
    _, key = _keys(30)
    keys = trandom.split(key, s)
    w = torch.from_numpy(_weights("gamma", (s, n), seed=31))
    p = torch.randn(s, n, generator=torch.Generator().manual_seed(2))
    singles = torch.stack([r(keys[i], w[i]) for i in range(s)])
    assert torch.equal(r.batch_rows(keys, w), singles)
    prow, arow = r.apply_rows(keys, w, p)
    assert torch.equal(arow, singles) and torch.equal(prow, torch.gather(p, 1, singles.long()))
    assert torch.equal(r.batch(key, w), singles)  # split(key, S) == keys here
    assert torch.equal(r.apply_batch(key, w, p)[1], singles)
    assert torch.equal(r.apply(keys[1], w[1], p[1])[1], singles[1])
    lw = w.log()
    _, sanc, _ = r.step_rows(keys, lw, p, 1.0)
    assert torch.equal(sanc[2], r.step(keys[2], lw[2], p[2], 1.0)[1])
    other = r.batch_rows(trandom.split(trandom.fold_in(key, 1), s), w)
    assert not torch.equal(other, singles)


# --------------------------------------------------------- spec and convert
@pytest.mark.parametrize("field,value,err", (
    ("max_iters", 0, ValueError),
    ("max_iters", -1, ValueError),
    ("max_iters", True, ValueError),
    ("max_iters", 8.0, ValueError),
    ("max_iters", "auto", ValueError),
    ("backend", "reference", None),
    ("backend", "pallas", ValueError),
    ("backend", "xla", ValueError),
    ("backend", "tpu", ValueError),
    ("plane_dtype", "int8", ValueError),
    ("plane_dtype", "half", ValueError),
    ("plane_dtype", "float64", ValueError),
    ("guard", "flag", None),
    ("guard", "recover", None),
    ("guard", "loud", ValueError),
))
def test_spec_validates(field, value, err):
    if err is None:  # the reference backend and the guards build
        _builds_and_runs(RejectionSpec(max_iters=8, **{field: value}), field, value)
        return
    with pytest.raises(err):
        RejectionSpec(**{field: value})


def _builds_and_runs(spec, field, value):
    """A spec that validates builds, and its entry runs on the CPU."""
    r = spec.build()
    assert getattr(r.spec, field) == value
    anc = r(torch.zeros(2, dtype=torch.int64), torch.full((2048,), 1.0 / 2048))
    assert anc.shape == (2048,) and anc.dtype == torch.int32


def test_spec_defaults():
    spec = RejectionSpec()
    assert (spec.max_iters, spec.backend, spec.name) == (1024, "cuda", "rejection")
    assert not hasattr(spec, "num_iters")
    assert spec.replace(max_iters=8) == RejectionSpec(max_iters=8)
    assert repr(spec.build()) == f"Resampler({spec!r})"


def test_convert_spec_round_trip():
    spec = convert.spec_from_jax(JaxSpec(max_iters=64, backend="pallas"))
    assert spec == RejectionSpec(max_iters=64)
    assert convert.spec_from_jax(JaxSpec(**convert.spec_to_jax(spec))) == spec
    assert convert.spec_from_jax(JaxSpec(backend="pallas_interpret")) == RejectionSpec()
    assert convert.spec_from_jax(JaxSpec()) == RejectionSpec(backend="reference")


def test_step_computes_nothing_on_the_host(monkeypatch):
    """``step`` has no 'auto' to resolve: no normalisation runs before the
    launch."""
    n = 4096
    lw = torch.from_numpy(_log_weights("normal", (2, n), seed=40))
    p = torch.randn(2, n, generator=torch.Generator().manual_seed(3))
    key = trandom.PRNGKey(41)
    r = RejectionSpec(max_iters=8).build()

    def refuse(*args, **kwargs):
        raise AssertionError("normalise_log_weights ran before the launch")

    monkeypatch.setattr(tspec, "normalise_log_weights", refuse)
    r.step(key, lw[0], p[0], 0.5)
    r.step_rows(trandom.split(key, 2), lw, p, 0.5)


def test_batch_seeds_follow_the_jax_wrapper(monkeypatch):
    """``batch`` hands its one launch ``key_to_seed(split(key, S))``, the
    seeds of ``rejection_tpu_batch``."""
    from repro.core.resamplers.batched import split_batch_keys
    from repro.kernels.common import key_to_seed as jax_key_to_seed

    jkey, tkey = _keys(50)
    seen = []
    monkeypatch.setattr(rops, "rejection_batch", lambda w, seeds, m: seen.append(seeds))
    rops.rejection_cuda_batch(tkey, torch.rand(3, 1024), 4)
    want = jax_key_to_seed(split_batch_keys(jkey, 3))
    np.testing.assert_array_equal(seen[0].numpy(), np.asarray(want).astype(np.int64))


# ---------------------------------------------------------------- the filter
N, T = 8192, 10


@pytest.fixture(scope="module")
def sim():
    key = jax.random.PRNGKey(1)
    xs, zs = jf.simulate(key, jm.ungm(), T)
    return key, np.array(xs), np.array(zs)


def _tkey(key):
    return convert.key_from_jax(jax.random.key_data(key))


def test_replay_alg6_bits(sim):
    """The JAX Alg. 6 filter step by step; its pre-resample particles,
    weights and resample key go through the port's fused resample stage,
    which must return the same particles and ancestors bit for bit."""
    _, _, zs = sim
    model = jm.ungm()
    jpf = jf.ParticleFilter(model, N, resampler=JaxSpec(backend="pallas_interpret"))
    tpf = tf.ParticleFilter(tm.ungm(), N, resampler=RejectionSpec())
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


@pytest.mark.parametrize("entry", ("run_filter", "run_filter_bank"))
def test_run_filter_matches(sim, entry, capsys):
    """Conditional runs (threshold 0.5) against JAX within
    ``WHOLE_RUN_ATOL``: one filter, and a bank of 2."""
    key, _, zs = sim
    jspec = JaxSpec(backend="pallas_interpret")
    jpf = jf.ParticleFilter(jm.ungm(), N, resampler=jspec, ess_threshold=0.5)
    tpf = tf.ParticleFilter(tm.ungm(), N, resampler=convert.spec_from_jax(jspec),
                            ess_threshold=0.5)
    obs = zs if entry == "run_filter" else np.stack([zs[:6], zs[:6] * 0.5])
    jest = getattr(jf, entry)(key, jpf, jnp.asarray(obs))
    test = getattr(tf, entry)(_tkey(key), tpf, torch.from_numpy(obs), device="cpu")
    assert test.shape == obs.shape
    with capsys.disabled():
        gap = float(np.abs(test.numpy() - np.asarray(jest)).max())
        print(f"\nrejection {entry} (threshold 0.5) vs JAX: max |estimate gap| {gap:.3g}")
    np.testing.assert_allclose(test.numpy(), np.asarray(jest), atol=WHOLE_RUN_ATOL, rtol=0)


def test_particle_filter_takes_rejection():
    pf = tf.ParticleFilter(tm.ungm(), N, resampler=RejectionSpec(max_iters=4))
    assert pf.spec == RejectionSpec(max_iters=4)
