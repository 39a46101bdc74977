"""The port's Megopolis kernels (plain versions on the CPU) against the JAX
package's Pallas kernels in interpret mode, at kernel and wrapper level.

* ``apply`` forms take linear weights: ancestors and states must match bit
  for bit, subnormal weights included (both sides flush them).
* ``step`` forms from raw log-weights: torch's ``exp`` is 1 ULP off
  XLA's on some inputs (ROADMAP Queue C, item 2) and the stats' sums run
  in another order, so
  the stats are held to ``STATS_RTOL``/``INCR_ATOL`` and the ancestors to a
  mismatch rate of at most ``MAX_MISMATCH_RATE`` (a 1-ULP weight flips an
  accept only where ``u·w[k]`` and ``w[j]`` fall within 1 ULP;
  ``test_step_mismatch_rate_sweep`` prints the count).
* ``step`` fed the weights JAX normalised must equal the port's own
  ``apply`` bit for bit.
* Bank row ``s`` equals the single call with ``keys[s]``.
* The CUDA kernels' index arithmetic (each block's comparison segment and
  its rotated slot), written out in Python, equals ``megopolis_indices``,
  and the §2.4 sectors per warp-iteration of a lane gather.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.metrics import normalise_log_weights as jax_normalise
from repro.core.spec import MegopolisSpec as JaxSpec
from repro.kernels.common import key_to_seed as jax_key_to_seed
from repro.kernels.megopolis import megopolis as jk
from repro_torch.convert import key_from_jax, spec_from_jax
from repro_torch.core.spec import MegopolisSpec
from repro_torch.core.transactions import transactions_per_group
from repro_torch.kernels.common import SEG, megopolis_indices
from repro_torch.kernels.megopolis import megopolis as tk
from repro_torch.kernels.megopolis import ref
from repro_torch.kernels.megopolis.ops import key_tables

STATS_RTOL = 2e-6
INCR_ATOL = 2e-6
MAX_MISMATCH_RATE = 1e-3


@pytest.fixture(autouse=True)
def _partitionable():
    assert jax.config.jax_threefry_partitionable


def _weights(kind: str, shape, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "gamma":
        return rng.gamma(0.5, size=shape).astype(np.float32)
    if kind == "subnormal":
        # UNGM-like likelihoods: a share of weights below the normal range.
        w = np.exp(-0.5 * rng.uniform(0, 14, size=shape) ** 2).astype(np.float32)
        w[..., ::7] = np.float32(1e-39)
        return w
    if kind == "tiny_normal":
        # u·w[k] lands in the subnormal range: the product's flush decides.
        return (rng.uniform(1.0, 4.0, size=shape) * 1.5e-38).astype(np.float32)
    raise ValueError(kind)


def _tables(n, b, rows, seed=0):
    rng = np.random.default_rng(seed + 100)
    offsets = rng.integers(0, n, size=(rows, b), dtype=np.int64).astype(np.int32)
    seeds = rng.integers(0, 2**32, size=rows, dtype=np.uint64).astype(np.uint32)
    return offsets, seeds


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.int32)


# ---------------------------------------------------------------- kernel level
@pytest.mark.parametrize("kind", ("gamma", "subnormal", "tiny_normal"))
@pytest.mark.parametrize("n,b", ((4096, 1), (4096, 16), (8192, 8)))
def test_fused_kernel_bits(kind, n, b):
    w = _weights(kind, n)
    state = np.random.default_rng(2).normal(size=n).astype(np.float32)
    offsets, seeds = _tables(n, b, 1)
    k2, out = jk.megopolis_pallas_fused(
        jnp.asarray(w.reshape(-1, 128)), jnp.asarray(state.reshape(1, -1, 128)),
        jnp.asarray(offsets[0]), jnp.asarray(seeds), num_iters=b, interpret=True)
    anc, got = tk.megopolis_fused(torch.from_numpy(w), torch.from_numpy(state)[None],
                                  torch.from_numpy(offsets[0]),
                                  torch.tensor(int(seeds[0])))
    np.testing.assert_array_equal(anc.numpy(), np.asarray(k2).reshape(n))
    np.testing.assert_array_equal(_bits(got.numpy()[0]), _bits(np.asarray(out).reshape(n)))


@pytest.mark.parametrize("kind", ("gamma", "subnormal"))
def test_fused_rows_kernel_bits(kind):
    s, n, b = 3, 4096, 8
    w = _weights(kind, (s, n))
    state = np.random.default_rng(3).normal(size=(s, 1, n)).astype(np.float32)
    offsets, seeds = _tables(n, b, s)
    k3, out = jk.megopolis_pallas_fused_rows(
        jnp.asarray(w.reshape(s, -1, 128)), jnp.asarray(state.reshape(s, 1, -1, 128)),
        jnp.asarray(offsets), jnp.asarray(seeds), num_iters=b, interpret=True)
    anc, got = tk.megopolis_fused_rows(torch.from_numpy(w), torch.from_numpy(state),
                                       torch.from_numpy(offsets),
                                       torch.from_numpy(seeds.astype(np.int64)))
    np.testing.assert_array_equal(anc.numpy(), np.asarray(k3).reshape(s, n))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(np.asarray(out).reshape(s, 1, n)))


@pytest.mark.parametrize("kind", ("gamma", "subnormal", "tiny_normal"))
@pytest.mark.parametrize("n,b", ((4096, 16), (3072, 8)))
def test_index_only_kernel_bits(kind, n, b):
    """Row 1: ``megopolis_pallas``, ancestors only."""
    w = _weights(kind, n, seed=3)
    offsets, seeds = _tables(n, b, 1, seed=3)
    k2 = jk.megopolis_pallas(jnp.asarray(w.reshape(-1, 128)), jnp.asarray(offsets[0]),
                             jnp.asarray(seeds), num_iters=b, interpret=True)
    anc = tk.megopolis(torch.from_numpy(w), torch.from_numpy(offsets[0]),
                       torch.tensor(int(seeds[0])))
    np.testing.assert_array_equal(anc.numpy(), np.asarray(k2).reshape(n))


@pytest.mark.parametrize("n", (4096, 3072))
def test_batch_kernel_bits(n):
    """Row 2: ``megopolis_pallas_batch``, one offset table for the bank; and
    its vmapped row-1 form over per-row tables."""
    s, b = 3, 8
    w = _weights("subnormal", (s, n), seed=4)
    offsets, seeds = _tables(n, b, s, seed=4)
    k3 = jk.megopolis_pallas_batch(jnp.asarray(w.reshape(s, -1, 128)), jnp.asarray(offsets[0]),
                                   jnp.asarray(seeds), num_iters=b, interpret=True)
    tseeds = torch.from_numpy(seeds.astype(np.int64))
    anc = tk.megopolis_batch(torch.from_numpy(w), torch.from_numpy(offsets[0]), tseeds)
    np.testing.assert_array_equal(anc.numpy(), np.asarray(k3).reshape(s, n))
    rows = jax.vmap(lambda w2, o, sd: jk.megopolis_pallas(w2, o, sd, num_iters=b,
                                                          interpret=True))(
        jnp.asarray(w.reshape(s, -1, 128)), jnp.asarray(offsets), jnp.asarray(seeds)[:, None])
    got = tk.megopolis_rows(torch.from_numpy(w), torch.from_numpy(offsets), tseeds)
    np.testing.assert_array_equal(got.numpy(), np.asarray(rows).reshape(s, n))


def _log_weights(kind, shape, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return (rng.normal(size=shape) * 3).astype(np.float32)
    if kind == "ungm":
        return (-0.5 * rng.uniform(0, 12, size=shape) ** 2).astype(np.float32)
    if kind == "dead":
        return np.full(shape, -np.inf, np.float32)
    raise ValueError(kind)


def _check_step(anc, stats, janc, jstats, n):
    jstats = np.asarray(jstats).reshape(stats.shape)
    stats = stats.numpy()
    np.testing.assert_array_equal(stats[..., 2], jstats[..., 2])  # same trigger
    np.testing.assert_allclose(stats[..., [0, 3]], jstats[..., [0, 3]], rtol=STATS_RTOL)
    np.testing.assert_allclose(stats[..., 1], jstats[..., 1], atol=INCR_ATOL, equal_nan=True)
    rate = (anc.numpy() != np.asarray(janc).reshape(anc.shape)).mean()
    assert rate <= MAX_MISMATCH_RATE


@pytest.mark.parametrize("kind", ("normal", "ungm", "dead"))
@pytest.mark.parametrize("thr", (0.0, 0.5, 1.0))
def test_step_kernel(kind, thr):
    n, b = 4096, 8
    lw = _log_weights(kind, n)
    state = np.random.default_rng(4).normal(size=n).astype(np.float32)
    offsets, seeds = _tables(n, b, 1)
    k2, out, stats = jk.megopolis_pallas_step(
        jnp.asarray(lw.reshape(-1, 128)), jnp.asarray(state.reshape(1, -1, 128)),
        jnp.asarray(offsets[0]), jnp.asarray(seeds), jnp.float32([thr]), num_iters=b,
        interpret=True)
    anc, got, st = tk.megopolis_step(torch.from_numpy(lw), torch.from_numpy(state)[None],
                                     torch.from_numpy(offsets[0]),
                                     torch.tensor(int(seeds[0])), thr)
    _check_step(anc, st, k2, stats, n)
    np.testing.assert_array_equal(got.numpy()[0], state[anc.numpy()])


def test_step_mismatch_rate_sweep(capsys):
    """Ancestor mismatches of the plain step against the Pallas step from
    raw log-weights, over seeds and weight families; printed for the
    record and held to the stated bound."""
    n, b = 4096, 16
    total = mismatched = 0
    for seed in range(4):
        for kind in ("normal", "ungm"):
            lw = _log_weights(kind, n, seed=seed)
            offsets, seeds = _tables(n, b, 1, seed=seed)
            k2, _, stats = jk.megopolis_pallas_step(
                jnp.asarray(lw.reshape(-1, 128)), jnp.zeros((1, n // 128, 128)),
                jnp.asarray(offsets[0]), jnp.asarray(seeds), jnp.float32([1.0]),
                num_iters=b, interpret=True)
            anc, _, st = tk.megopolis_step(torch.from_numpy(lw), torch.zeros(1, n),
                                           torch.from_numpy(offsets[0]),
                                           torch.tensor(int(seeds[0])), 1.0)
            total += n
            mismatched += int((anc.numpy() != np.asarray(k2).reshape(n)).sum())
    with capsys.disabled():
        print(f"\nstep ancestor mismatches vs Pallas: {mismatched} of {total}")
    assert mismatched / total <= MAX_MISMATCH_RATE


def test_step_rows_kernel():
    s, n, b = 3, 4096, 8
    lw = np.stack([_log_weights(k, n, seed=i) for i, k in enumerate(("normal", "ungm", "dead"))])
    state = np.random.default_rng(5).normal(size=(s, 1, n)).astype(np.float32)
    offsets, seeds = _tables(n, b, s)
    k3, out, stats = jk.megopolis_pallas_step_rows(
        jnp.asarray(lw.reshape(s, -1, 128)), jnp.asarray(state.reshape(s, 1, -1, 128)),
        jnp.asarray(offsets), jnp.asarray(seeds), jnp.float32([0.5]), num_iters=b,
        interpret=True)
    anc, got, st = tk.megopolis_step_rows(torch.from_numpy(lw), torch.from_numpy(state),
                                          torch.from_numpy(offsets),
                                          torch.from_numpy(seeds.astype(np.int64)), 0.5)
    _check_step(anc, st, k3, stats, n)


def test_wrappers_on_cpu_count_no_launch():
    tk.reset_launch_counts()
    n = 4096
    w = torch.rand(2, n)
    offsets = torch.zeros((2, 4), dtype=torch.int32)
    tk.megopolis_fused_rows(w, w[:, None], offsets, torch.tensor([1, 2]))
    tk.megopolis_step_rows(w.log(), w[:, None], offsets, torch.tensor([1, 2]), 0.5)
    tk.megopolis_fused(w[0], w[:1], offsets[0], torch.tensor(3))
    tk.megopolis_step(w[0].log(), w[:1], offsets[0], torch.tensor(3), 0.5)
    tk.megopolis_rows(w, offsets, torch.tensor([1, 2]))
    tk.megopolis_batch(w, offsets[0], torch.tensor([1, 2]))
    tk.megopolis(w[0], offsets[0], torch.tensor(3))
    assert [fn.launches for fn in tk.WRAPPERS] == [0] * 7


@pytest.mark.parametrize("bad", ("n", "offsets", "state", "dtype"))
def test_wrappers_validate(bad):
    n = 2048 if bad == "n" else 4096
    w = torch.rand(1, n, dtype=torch.float64 if bad == "dtype" else torch.float32)
    state = torch.zeros(1, 1, 1024) if bad == "state" else torch.zeros(1, 1, n)
    offsets = torch.full((1, 4), n if bad == "offsets" else 0, dtype=torch.int32)
    if bad == "n":
        w, state = torch.rand(1, 1000), torch.zeros(1, 1, 1000)
    with pytest.raises(ValueError):
        tk.megopolis_fused_rows(w, state, offsets, torch.tensor([1]))


# --------------------------------------------------------------- wrapper level
def _resamplers(b):
    jr = JaxSpec(num_iters=b, segment=1024, backend="pallas_interpret").build()
    return jr, spec_from_jax(jr.spec).build()


def _keys(seed, rows=None):
    key = jax.random.PRNGKey(seed)
    if rows is not None:
        key = jax.random.split(key, rows)
    return key, key_from_jax(jax.random.key_data(key))


@pytest.mark.parametrize("kind", ("gamma", "subnormal"))
@pytest.mark.parametrize("dims", ((), (3,)))
def test_apply_bits(kind, dims):
    n, b = 4096, 16
    jr, tr = _resamplers(b)
    w = _weights(kind, n, seed=7)
    p = np.random.default_rng(8).normal(size=(n,) + dims).astype(np.float32)
    jkey, tkey = _keys(11)
    jp, ja = jr.apply(jkey, jnp.asarray(w), jnp.asarray(p))
    tp, ta = tr.apply(tkey, torch.from_numpy(w), torch.from_numpy(p))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(_bits(tp.numpy()), _bits(np.asarray(jp)))


@pytest.mark.parametrize("entry", ("apply_rows", "apply_batch"))
def test_apply_bank_bits(entry):
    s, n, b = 3, 4096, 8
    jr, tr = _resamplers(b)
    w = _weights("subnormal", (s, n), seed=9)
    p = np.random.default_rng(10).normal(size=(s, n)).astype(np.float32)
    jkey, tkey = _keys(12, rows=s if entry == "apply_rows" else None)
    jp, ja = getattr(jr, entry)(jkey, jnp.asarray(w), jnp.asarray(p))
    tp, ta = getattr(tr, entry)(tkey, torch.from_numpy(w), torch.from_numpy(p))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(_bits(tp.numpy()), _bits(np.asarray(jp)))


@pytest.mark.parametrize("entry", ("__call__", "batch", "batch_rows"))
@pytest.mark.parametrize("n", (4096, 3072))
def test_index_only_entries_bits(entry, n):
    s, b = 3, 8
    jr, tr = _resamplers(b)
    w = _weights("subnormal", (s, n) if entry != "__call__" else n, seed=30)
    jkey, tkey = _keys(31, rows=s if entry == "batch_rows" else None)
    jfn = jr if entry == "__call__" else getattr(jr, entry)
    tfn = tr if entry == "__call__" else getattr(tr, entry)
    np.testing.assert_array_equal(tfn(tkey, torch.from_numpy(w)).numpy(),
                                  np.asarray(jfn(jkey, jnp.asarray(w))))


@pytest.mark.parametrize("thr", (0.3, 1.0))
def test_step_wrapper(thr):
    n, b = 8192, 8
    jr, tr = _resamplers(b)
    lw = _log_weights("ungm", n, seed=13)
    p = np.random.default_rng(14).normal(size=n).astype(np.float32)
    jkey, tkey = _keys(15)
    jp, ja, js = jr.step(jkey, jnp.asarray(lw), jnp.asarray(p), thr)
    tp, ta, ts = tr.step(tkey, torch.from_numpy(lw), torch.from_numpy(p), thr)
    jvec = np.stack([np.asarray(js.ess_norm), np.asarray(js.log_evidence_incr),
                     np.asarray(js.resampled), np.asarray(js.max_weight)])
    tvec = torch.stack([ts.ess_norm, ts.log_evidence_incr, ts.resampled, ts.max_weight])
    _check_step(ta, tvec, ja, jvec, n)
    if (ta.numpy() == np.asarray(ja)).all():
        assert int(ts.survivors) == int(js.survivors)
    assert bool(ts.degenerate) == bool(js.degenerate)


def test_step_rows_wrapper():
    s, n, b = 3, 4096, 8
    jr, tr = _resamplers(b)
    lw = np.stack([_log_weights(k, n, seed=i) for i, k in enumerate(("normal", "ungm", "dead"))])
    p = np.random.default_rng(16).normal(size=(s, n, 2)).astype(np.float32)
    jkey, tkey = _keys(17, rows=s)
    jp, ja, js = jr.step_rows(jkey, jnp.asarray(lw), jnp.asarray(p), 0.5)
    tp, ta, ts = tr.step_rows(tkey, torch.from_numpy(lw), torch.from_numpy(p), 0.5)
    jvec = np.stack([np.asarray(getattr(js, f)) for f in
                     ("ess_norm", "log_evidence_incr", "resampled", "max_weight")], -1)
    tvec = torch.stack([ts.ess_norm, ts.log_evidence_incr, ts.resampled, ts.max_weight], -1)
    _check_step(ta, tvec, ja, jvec, n)
    np.testing.assert_array_equal(ts.degenerate.numpy(), np.asarray(js.degenerate))


def test_step_on_reference_weights_equals_apply():
    """The resample branch of the JAX step, fed through the port's apply
    with the weights JAX normalised, is bit-identical."""
    n, b = 4096, 16
    jr, tr = _resamplers(b)
    lw = _log_weights("ungm", n, seed=18)
    p = np.random.default_rng(19).normal(size=n).astype(np.float32)
    jkey, tkey = _keys(20)
    jp, ja, js = jr.step(jkey, jnp.asarray(lw), jnp.asarray(p), 1.0)
    assert float(js.resampled) == 1.0
    w_ref = np.array(jax.jit(jax_normalise)(jnp.asarray(lw)))
    tp, ta = tr.apply(tkey, torch.from_numpy(w_ref), torch.from_numpy(p))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(_bits(tp.numpy()), _bits(np.asarray(jp)))


def test_wrapper_tables_follow_jax_derivation():
    n, b = 4096, 8
    jkey, tkey = _keys(21)
    key_off, key_seed = jax.random.split(jkey)
    want_off = np.asarray(jax.random.randint(key_off, (b,), 0, n, dtype=jnp.int32))
    want_seed = int(jax_key_to_seed(key_seed))
    offsets, seed = key_tables(tkey, n, b)
    np.testing.assert_array_equal(offsets.numpy(), want_off)
    assert int(seed) == want_seed


# ----------------------------------------------------------------- port only
@pytest.mark.parametrize("num_iters", (8, "auto"))
def test_bank_row_equals_single_call(num_iters):
    s, n = 3, 4096
    tr = MegopolisSpec(num_iters=num_iters).build()
    _, keys = _keys(22, rows=s)
    w = torch.from_numpy(_weights("gamma", (s, n), seed=23))
    lw = torch.from_numpy(_log_weights("ungm", (s, n), seed=24))
    p = torch.randn(s, n, generator=torch.Generator().manual_seed(0))
    bp, ba = tr.apply_rows(keys, w, p)
    sp, sa, sst = tr.step_rows(keys, lw, p, 0.7)
    for r in range(s):
        rp, ra = tr.apply(keys[r], w[r], p[r])
        assert torch.equal(ba[r], ra) and torch.equal(bp[r], rp)
        qp, qa, qst = tr.step(keys[r], lw[r], p[r], 0.7)
        assert torch.equal(sa[r], qa) and torch.equal(sp[r], qp)
        for field, val in zip(sst._fields, sst):
            assert torch.equal(val[r], getattr(qst, field)), field


def test_auto_iterations_match_jax():
    n = 4096
    jr = JaxSpec(num_iters="auto", segment=1024, backend="pallas_interpret").build()
    tr = MegopolisSpec().build()
    w = _weights("gamma", n, seed=25)
    p = np.arange(n, dtype=np.float32)
    jkey, tkey = _keys(26)
    jp, ja = jr.apply(jkey, jnp.asarray(w), jnp.asarray(p))
    tp, ta = tr.apply(tkey, torch.from_numpy(w), torch.from_numpy(p))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


@pytest.mark.parametrize("entry", ("__call__", "batch", "batch_rows"))
def test_index_only_entries_are_next_slice(entry):
    """``__call__``, ``batch`` and ``batch_rows`` give the ancestors of the
    matching apply entry (the name is kept so the test stays traceable)."""
    s, n = 3, 4096
    r = MegopolisSpec(num_iters=8).build()
    key, keys = _keys(28)[1], _keys(28, rows=s)[1]
    w = torch.from_numpy(_weights("gamma", (s, n), seed=29))
    p = torch.zeros(s, n)
    if entry == "__call__":
        assert torch.equal(r(key, w[0]), r.apply(key, w[0], p[0])[1])
    elif entry == "batch":
        assert torch.equal(r.batch(key, w), r.apply_batch(key, w, p)[1])
    else:
        assert torch.equal(r.batch_rows(keys, w), r.apply_rows(keys, w, p)[1])


@pytest.mark.parametrize("field,value,err", (
    ("backend", "reference", NotImplementedError),
    ("backend", "pallas", NotImplementedError),
    ("backend", "tpu", ValueError),
    ("plane_dtype", "bfloat16", NotImplementedError),
    ("plane_dtype", "float64", ValueError),
    ("guard", "flag", NotImplementedError),
    ("guard", "recover", NotImplementedError),
    ("guard", "loud", ValueError),
    ("segment", 32, ValueError),
    ("num_iters", 0, ValueError),
))
def test_spec_validates(field, value, err):
    with pytest.raises(err):
        MegopolisSpec(**{field: value})


def test_entries_check_shapes():
    r = MegopolisSpec(num_iters=4).build()
    with pytest.raises(ValueError):
        r.apply(torch.zeros(2, dtype=torch.int64), torch.ones(2, 4096), torch.ones(2, 4096))
    with pytest.raises(ValueError):
        r.apply_rows(torch.zeros(3, 2, dtype=torch.int64), torch.ones(2, 4096),
                     torch.ones(2, 4096))


def test_ref_matches_composition():
    """The plain step's resample branch is the plain apply on exp(lw - m)."""
    n = 4096
    lw = torch.from_numpy(_log_weights("normal", (2, n), seed=27))
    state = torch.randn(2, 1, n, generator=torch.Generator().manual_seed(1))
    offsets, seeds = _tables(n, 8, 2)
    offsets, seeds = torch.from_numpy(offsets), torch.from_numpy(seeds.astype(np.int64))
    anc, out, stats = ref.megopolis_step_rows_ref(lw, state, offsets, seeds, 1.0)
    w = torch.exp(lw - lw.amax(dim=1, keepdim=True))
    anc2, out2 = ref.megopolis_fused_rows_ref(w, state, offsets, seeds)
    assert torch.equal(anc, anc2) and torch.equal(out, out2)
    assert stats[:, 2].eq(1).all()


# ------------------------------------------------- the CUDA kernels' indexing
def _ring_index(i: torch.Tensor, o: int, n: int) -> torch.Tensor:
    """The comparison index as ``megopolis.cu``'s sweep forms it, written
    out in Python: the block of segment ``i >> 10`` requests comparison
    segment ``c = ((i >> 10) + (o >> 10)) mod (N / 1024)`` (one subtraction);
    two bulk copies fill its ring buffer with words ``a .. 1023``, then ``0
    .. a + 3`` of that segment, ``a = (o mod 1024)`` rounded down to 4; lane
    ``i`` reads buffer word ``(i mod 1024) + (o mod 4)``.  This documents the
    arithmetic the kernel is written from; the kernel itself is held to the
    plain version on the card (``tests/test_torch_cuda.py``, at these
    offsets too)."""
    tiles = n // SEG
    c = (i >> 10) + (o >> 10)
    c = torch.where(c >= tiles, c - tiles, c)
    a = (o % SEG) & ~3
    buffer = torch.cat([torch.arange(a, SEG), torch.arange(0, a + 4)])  # segment words
    slot = buffer[(i % SEG) + (o % 4)]
    return c * SEG + slot


def _ring_offsets(n: int) -> list:
    """0, the first offsets off a sector and a segment boundary, the segment
    boundary itself, a middle offset and the last offsets before N (their
    lanes wrap past the row's end)."""
    cand = (0, 1, 7, 8, SEG - 1, SEG, SEG + 1, n // 2 + 3, n - SEG, n - SEG + 1, n - 1)
    return sorted({o for o in cand if 0 <= o < n})


@pytest.mark.parametrize("n,o", [(n, o) for n in (1024, 2048, 8192) for o in _ring_offsets(n)])
def test_ring_index_equals_megopolis_indices(n, o):
    i = torch.arange(n, dtype=torch.int64)
    want = megopolis_indices(i, torch.tensor(o), SEG, n)
    assert torch.equal(_ring_index(i, o, n), want)
    # For a fixed offset the map is a bijection: each block's comparison
    # segment is one whole 4 KiB segment, and every w value is read once.
    assert torch.equal(torch.sort(want // SEG).values, torch.arange(n) // SEG)
    assert torch.equal(torch.sort(want).values, i)


@pytest.mark.parametrize("o", (0, 1, 7, 8, 31, 32, 1000, 1023, 1024, 4095))
def test_sectors_per_warp_iteration(o):
    """The §2.4 count from the addresses at the kernels' segment of 1024: a
    warp whose 32 lanes gather their own w[j] (the kernel before its ring of
    segment copies) touches 5 32-byte sectors unless o ≡ 0 mod 8, 4 then.
    The copies move whole 4 KiB segments, 4 sectors a warp-iteration at any
    offset."""
    n = 4096
    j = megopolis_indices(torch.arange(n), torch.tensor(o), SEG, n).numpy()
    per_warp = transactions_per_group(j, group=32, word_bytes=4, segment_bytes=32)
    assert set(per_warp.tolist()) == {4 if o % 8 == 0 else 5}
