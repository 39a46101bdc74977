"""The port's Metropolis kernels (paper Alg. 2; plain versions on the CPU)
against the JAX package's Pallas kernels in interpret mode, at kernel and
entry level, and the two families' bank contracts.

* The index-only and ``apply`` forms take linear weights: ancestors and
  states must match bit for bit, subnormal weights included (both sides
  flush them).  N = 3072 is a multiple of 1024 that is not a power of two,
  where an unsigned ``hash mod N`` slip would show.
* ``step`` forms from raw log-weights: torch's ``exp`` is 1 ULP off XLA's
  on some inputs (ROADMAP Queue C, item 2) and the stats' sums run in
  another order, so the stats are held to ``STATS_RTOL``/``INCR_ATOL`` and
  the ancestors to a mismatch rate of at most ``MAX_MISMATCH_RATE``, the
  bounds of ``test_torch_megopolis.py``.
* Bank contracts: Metropolis ``batch`` row ``s`` is the single call with
  ``split(key, S)[s]``; Megopolis ``batch`` shares one offset table, so it
  is not; ``batch_rows`` row ``s`` is the single call with ``keys[s]`` for
  both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.spec import MegopolisSpec as JaxMegopolisSpec
from repro.core.spec import MetropolisSpec as JaxSpec
from repro.kernels import common as jc
from repro.kernels.metropolis import metropolis as jk
from repro_torch import convert
from repro_torch import random as trandom
from repro_torch.core.spec import MegopolisSpec, MetropolisSpec
from repro_torch.kernels.metropolis import metropolis as tk
from repro_torch.kernels.metropolis import ref

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
        w = np.exp(-0.5 * rng.uniform(0, 14, size=shape) ** 2).astype(np.float32)
        w[..., ::7] = np.float32(1e-39)
        return w
    if kind == "tiny_normal":
        return (rng.uniform(1.0, 4.0, size=shape) * 1.5e-38).astype(np.float32)
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


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int64) if x.dtype == np.uint32 else x)


# ---------------------------------------------------------------- kernel level
@pytest.mark.parametrize("kind", ("gamma", "subnormal", "tiny_normal"))
@pytest.mark.parametrize("n,b", ((4096, 1), (4096, 16), (8192, 8), (3072, 12)))
def test_kernel_bits(kind, n, b):
    """Rows 7 and 9: index-only and fused, one population."""
    w = _weights(kind, n)
    state = np.random.default_rng(2).normal(size=n).astype(np.float32)
    seeds = _seeds(1)
    w2 = jnp.asarray(w.reshape(-1, 128))
    jk2 = jk.metropolis_pallas(w2, jnp.asarray(seeds), num_iters=b, interpret=True)
    jf2, jout = jk.metropolis_pallas_fused(w2, jnp.asarray(state.reshape(1, -1, 128)),
                                           jnp.asarray(seeds), num_iters=b, interpret=True)
    anc = tk.metropolis(torch.from_numpy(w), _t(seeds)[0], b)
    fanc, got = tk.metropolis_fused(torch.from_numpy(w), torch.from_numpy(state)[None],
                                    _t(seeds)[0], b)
    np.testing.assert_array_equal(anc.numpy(), np.asarray(jk2).reshape(n))
    np.testing.assert_array_equal(fanc.numpy(), np.asarray(jf2).reshape(n))
    np.testing.assert_array_equal(_bits(got.numpy()[0]), _bits(np.asarray(jout).reshape(n)))


@pytest.mark.parametrize("n", (4096, 3072))
def test_batch_kernel_bits(n):
    """Rows 8 and 10: a bank, one seed per row."""
    s, b = 3, 8
    w = _weights("subnormal", (s, n), seed=1)
    state = np.random.default_rng(3).normal(size=(s, 2, n)).astype(np.float32)
    seeds = _seeds(s, seed=1)
    w3 = jnp.asarray(w.reshape(s, -1, 128))
    jk3 = jk.metropolis_pallas_batch(w3, jnp.asarray(seeds), num_iters=b, interpret=True)
    jf3, jout = jk.metropolis_pallas_fused_batch(
        w3, jnp.asarray(state.reshape(s, 2, -1, 128)), jnp.asarray(seeds), num_iters=b,
        interpret=True)
    anc = tk.metropolis_batch(torch.from_numpy(w), _t(seeds), b)
    fanc, got = tk.metropolis_fused_batch(torch.from_numpy(w), torch.from_numpy(state),
                                          _t(seeds), b)
    np.testing.assert_array_equal(anc.numpy(), np.asarray(jk3).reshape(s, n))
    np.testing.assert_array_equal(fanc.numpy(), anc.numpy())
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(np.asarray(jout).reshape(s, 2, n)))


def _check_step(anc, stats, janc, jstats):
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
    """Row 11."""
    n, b = 4096, 8
    lw = _log_weights(kind, n)
    state = np.random.default_rng(4).normal(size=n).astype(np.float32)
    seeds = _seeds(1, seed=2)
    k2, out, stats = jk.metropolis_pallas_step(
        jnp.asarray(lw.reshape(-1, 128)), jnp.asarray(state.reshape(1, -1, 128)),
        jnp.asarray(seeds), jnp.float32([thr]), num_iters=b, interpret=True)
    anc, got, st = tk.metropolis_step(torch.from_numpy(lw), torch.from_numpy(state)[None],
                                      _t(seeds)[0], b, thr)
    _check_step(anc, st, k2, stats)
    np.testing.assert_array_equal(got.numpy()[0], state[anc.numpy()])


def test_step_rows_kernel():
    """Row 12: each row its own trigger, a dead row on the uniform bank."""
    s, n, b = 3, 3072, 8
    lw = np.stack([_log_weights(k, n, seed=i) for i, k in enumerate(("normal", "ungm", "dead"))])
    state = np.random.default_rng(5).normal(size=(s, 1, n)).astype(np.float32)
    seeds = _seeds(s, seed=3)
    k3, out, stats = jk.metropolis_pallas_step_rows(
        jnp.asarray(lw.reshape(s, -1, 128)), jnp.asarray(state.reshape(s, 1, -1, 128)),
        jnp.asarray(seeds), jnp.float32([0.5]), num_iters=b, interpret=True)
    anc, got, st = tk.metropolis_step_rows(torch.from_numpy(lw), torch.from_numpy(state),
                                           _t(seeds), b, 0.5)
    _check_step(anc, st, k3, stats)


def test_step_mismatch_rate_sweep(capsys):
    """Ancestor mismatches of the plain step against the Pallas step from
    raw log-weights over seeds and weight families; printed for the record
    and held to the stated bound."""
    n, b = 4096, 16
    total = mismatched = 0
    for seed in range(3):
        for kind in ("normal", "ungm"):
            lw = _log_weights(kind, n, seed=seed)
            seeds = _seeds(1, seed=seed)
            k2, _, _ = jk.metropolis_pallas_step(
                jnp.asarray(lw.reshape(-1, 128)), jnp.zeros((1, n // 128, 128)),
                jnp.asarray(seeds), jnp.float32([1.0]), num_iters=b, interpret=True)
            anc, _, _ = tk.metropolis_step(torch.from_numpy(lw), torch.zeros(1, n),
                                           _t(seeds)[0], b, 1.0)
            total += n
            mismatched += int((anc.numpy() != np.asarray(k2).reshape(n)).sum())
    with capsys.disabled():
        print(f"\nmetropolis step ancestor mismatches vs Pallas: {mismatched} of {total}")
    assert mismatched / total <= MAX_MISMATCH_RATE


@pytest.mark.parametrize("seed", (0, 0x9E3779B9, 2**32 - 1))
def test_accept_lane_at_the_largest_n(seed):
    """The accept lane ``(uint32)(i + N)`` and the proposal ``hash mod N`` at
    N = 2**30 - 1024, the largest N the port takes, for lanes at both ends
    of the row, against the JAX kernel's own expressions."""
    n = (1 << 30) - 1024
    lanes = np.array([0, 1, 1023, n // 2, n - 1025, n - 2, n - 1], np.int32)
    i = torch.from_numpy(lanes).to(torch.int64)
    for b in (0, 1, 31, 353):
        want_u = np.asarray(jc.hash_uniform(jnp.uint32(seed), jnp.asarray(lanes) + n, b))
        want_j = np.asarray(jc.hash_bits(jnp.uint32(seed), jnp.asarray(lanes), b)
                            % jnp.uint32(n)).astype(np.int64)
        got_u = ref.accept_uniform(seed, i, n, b).numpy()
        np.testing.assert_array_equal(got_u.view(np.int32), want_u.view(np.int32))
        np.testing.assert_array_equal(ref.proposal_index(seed, i, n, b).numpy(), want_j)


def test_wrappers_on_cpu_count_no_launch():
    tk.reset_launch_counts()
    n = 4096
    w = torch.rand(2, n)
    seeds = torch.tensor([1, 2])
    tk.metropolis(w[0], torch.tensor(3), 4)
    tk.metropolis_batch(w, seeds, 4)
    tk.metropolis_fused(w[0], w[:1], torch.tensor(3), 4)
    tk.metropolis_fused_batch(w, w[:, None], seeds, 4)
    tk.metropolis_step(w[0].log(), w[:1], torch.tensor(3), 4, 0.5)
    tk.metropolis_step_rows(w.log(), w[:, None], seeds, 4, 0.5)
    assert [fn.launches for fn in tk.WRAPPERS] == [0] * 6


@pytest.mark.parametrize("bad", ("n", "state", "dtype", "seeds", "iters"))
def test_wrappers_validate(bad):
    n = 1000 if bad == "n" else 4096
    w = torch.rand(2, n, dtype=torch.float64 if bad == "dtype" else torch.float32)
    state = torch.zeros(2, 1, 1024) if bad == "state" else torch.zeros(2, 1, n)
    seeds = torch.tensor([1]) if bad == "seeds" else torch.tensor([1, 2])
    with pytest.raises(ValueError):
        tk.metropolis_fused_batch(w, state, seeds, 0 if bad == "iters" else 4)


def test_ref_matches_composition():
    """The plain step's resample branch is the plain fused sweep on
    exp(lw - m)."""
    n = 4096
    lw = torch.from_numpy(_log_weights("normal", (2, n), seed=27))
    state = torch.randn(2, 1, n, generator=torch.Generator().manual_seed(1))
    seeds = torch.tensor([5, 2**32 - 3])
    anc, out, stats = ref.metropolis_step_rows_ref(lw, state, seeds, 8, 1.0)
    w = torch.exp(lw - lw.amax(dim=1, keepdim=True))
    anc2, out2 = ref.metropolis_rows_ref(w, state, seeds, 8)
    assert torch.equal(anc, anc2) and torch.equal(out, out2)
    assert torch.equal(ref.metropolis_rows_ref(w, None, seeds, 8), anc2)
    assert stats[:, 2].eq(1).all()


# ----------------------------------------------------------------- entry level
def _resamplers(b):
    jr = JaxSpec(num_iters=b, backend="pallas_interpret").build()
    return jr, convert.spec_from_jax(jr.spec).build()


def _keys(seed, rows=None):
    key = jax.random.PRNGKey(seed)
    if rows is not None:
        key = jax.random.split(key, rows)
    return key, convert.key_from_jax(jax.random.key_data(key))


@pytest.mark.parametrize("entry", ("__call__", "batch", "batch_rows", "apply", "apply_batch",
                                   "apply_rows"))
def test_entries_bits(entry):
    s, n, b = 3, 3072, 8
    jr, tr = _resamplers(b)
    bank = entry not in ("__call__", "apply")
    w = _weights("subnormal", (s, n) if bank else n, seed=9)
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


@pytest.mark.parametrize("thr", (0.3, 1.0))
def test_step_entry(thr):
    n, b = 8192, 8
    jr, tr = _resamplers(b)
    lw = _log_weights("ungm", n, seed=13)
    p = np.random.default_rng(14).normal(size=n).astype(np.float32)
    jkey, tkey = _keys(15)
    jp, ja, js = jr.step(jkey, jnp.asarray(lw), jnp.asarray(p), thr)
    tp, ta, ts = tr.step(tkey, torch.from_numpy(lw), torch.from_numpy(p), thr)
    _check_step(ta, torch.from_numpy(_stats_vec(ts, 0)), ja, _stats_vec(js, 0))
    assert bool(ts.degenerate) == bool(js.degenerate)


def test_step_rows_entry():
    s, n, b = 3, 4096, 8
    jr, tr = _resamplers(b)
    lw = np.stack([_log_weights(k, n, seed=i) for i, k in enumerate(("normal", "ungm", "dead"))])
    p = np.random.default_rng(16).normal(size=(s, n)).astype(np.float32)
    jkey, tkey = _keys(17, rows=s)
    jp, ja, js = jr.step_rows(jkey, jnp.asarray(lw), jnp.asarray(p), 0.5)
    tp, ta, ts = tr.step_rows(tkey, torch.from_numpy(lw), torch.from_numpy(p), 0.5)
    _check_step(ta, torch.from_numpy(_stats_vec(ts, -1)), ja, _stats_vec(js, -1))
    np.testing.assert_array_equal(ts.degenerate.numpy(), np.asarray(js.degenerate))


def test_step_on_reference_weights_equals_apply():
    """The resample branch of the JAX step, fed through the port's apply
    with the weights JAX normalised, is bit-identical."""
    from repro.core.metrics import normalise_log_weights as jax_normalise

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


# ------------------------------------------------------------- bank contracts
@pytest.mark.parametrize("family", ("metropolis", "megopolis"))
def test_bank_contracts(family):
    """``batch_rows``/``apply_rows`` rows are the single calls with
    ``keys[s]``; Metropolis ``batch``/``apply_batch`` rows are the single
    calls with ``split(key, S)[s]``; Megopolis ``batch`` shares one offset
    table, so its rows are not."""
    s, n = 4, 4096
    spec = MetropolisSpec(num_iters=8) if family == "metropolis" else MegopolisSpec(num_iters=8)
    r = spec.build()
    _, key = _keys(30)
    keys = trandom.split(key, s)
    w = torch.from_numpy(_weights("gamma", (s, n), seed=31))
    p = torch.randn(s, n, generator=torch.Generator().manual_seed(2))
    rows = r.batch_rows(keys, w)
    prow, arow = r.apply_rows(keys, w, p)
    singles = torch.stack([r(keys[i], w[i]) for i in range(s)])
    assert torch.equal(rows, singles) and torch.equal(arow, singles)
    assert torch.equal(prow, torch.gather(p, 1, singles.long()))
    batch = r.batch(key, w)
    assert torch.equal(r.apply_batch(key, w, p)[1], batch)
    if family == "metropolis":
        assert torch.equal(batch, singles)  # split(key, S) == keys here
    else:
        assert not torch.equal(batch, singles)


@pytest.mark.parametrize("family", ("metropolis", "megopolis"))
def test_auto_per_family(family):
    """'auto' as the JAX kernel path resolves it: per row for every
    Metropolis bank form, one B over the bank for Megopolis ``batch``;
    ``batch_rows`` raises ``TypeError`` on both sides."""
    s, n = 3, 4096
    if family == "metropolis":
        jr = JaxSpec(backend="pallas_interpret").build()
        tr = MetropolisSpec().build()
    else:
        jr = JaxMegopolisSpec(segment=1024, backend="pallas_interpret").build()
        tr = MegopolisSpec().build()
    # Rows of different concentration: eq. (3) gives them different B.
    w = np.stack([_weights("gamma", n, seed=32), np.ones(n, np.float32),
                  _weights("subnormal", n, seed=33)])
    jkey, tkey = _keys(34)
    np.testing.assert_array_equal(tr.batch(tkey, torch.from_numpy(w)).numpy(),
                                  np.asarray(jr.batch(jkey, jnp.asarray(w))))
    np.testing.assert_array_equal(tr(tkey, torch.from_numpy(w[0])).numpy(),
                                  np.asarray(jr(jkey, jnp.asarray(w[0]))))
    jkeys, tkeys = _keys(35, rows=s)
    with pytest.raises(TypeError):
        jr.batch_rows(jkeys, jnp.asarray(w))
    with pytest.raises(TypeError):
        tr.batch_rows(tkeys, torch.from_numpy(w))


@pytest.mark.parametrize("field,value,err", (
    ("backend", "reference", NotImplementedError),
    ("backend", "tpu", ValueError),
    ("plane_dtype", "bfloat16", NotImplementedError),
    ("guard", "recover", NotImplementedError),
    ("num_iters", 0, ValueError),
    ("num_iters", True, ValueError),
))
def test_spec_validates(field, value, err):
    with pytest.raises(err):
        MetropolisSpec(**{field: value})


def test_convert_spec_round_trip():
    spec = convert.spec_from_jax(JaxSpec(num_iters=32, backend="pallas"))
    assert spec == MetropolisSpec(num_iters=32)
    assert convert.spec_from_jax(JaxSpec(**convert.spec_to_jax(spec))) == spec
    assert convert.spec_from_jax(JaxSpec(backend="pallas_interpret")) == MetropolisSpec()
    with pytest.raises(NotImplementedError):
        convert.spec_from_jax(JaxSpec(num_iters=8, backend="xla"))
