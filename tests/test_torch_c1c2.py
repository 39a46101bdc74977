"""The port's Metropolis-C1/C2 kernels (paper Algs. 3-4; plain versions on
the CPU) against the JAX package's Pallas kernels in interpret mode, at
kernel, entry and filter level.

* Index-only and ``apply`` forms take linear weights: ancestors and states
  must match bit for bit, subnormal and tiny-normal weights included (both
  sides flush them).  N = 3072 has three tiles, not a power of two, where a
  partition taken per block instead of per own tile would show.
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
from repro.core.spec import MetropolisC1Spec as JaxC1Spec
from repro.core.spec import MetropolisC2Spec as JaxC2Spec
from repro.kernels.metropolis import c1c2 as jk
from repro.pf import filter as jf
from repro.pf import models as jm
from repro_torch import convert
from repro_torch import random as trandom
from repro_torch.core import spec as tspec
from repro_torch.core.spec import (
    MegopolisSpec,
    MetropolisC1Spec,
    MetropolisC2Spec,
    MetropolisSpec,
)
from repro_torch.kernels.metropolis import c1c2 as tk
from repro_torch.kernels.metropolis import ops as tops
from repro_torch.kernels.metropolis import ref
from repro_torch.pf import filter as tf
from repro_torch.pf import models as tm

STATS_RTOL = 2e-6
INCR_ATOL = 2e-6
MAX_MISMATCH_RATE = 1e-3
WHOLE_RUN_ATOL = 0.05
VARIANTS = (1, 2)
JAX_SPECS = {1: JaxC1Spec, 2: JaxC2Spec}
PORT_SPECS = {1: MetropolisC1Spec, 2: MetropolisC2Spec}


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


def _table(variant, n, b, rows=None, seed=0):
    tiles = n // 1024
    width = tiles if variant == 1 else tiles * b
    shape = (width,) if rows is None else (rows, width)
    return np.random.default_rng(seed + 200).integers(0, tiles, size=shape).astype(np.int32)


def _seeds(rows, seed=0):
    rng = np.random.default_rng(seed + 100)
    return rng.integers(0, 2**32, size=rows, dtype=np.uint64).astype(np.uint32)


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.int32)


def _jax_kernel(variant, kind):
    suffix = {"index": "", "fused": "_fused", "step": "_step"}[kind]
    return getattr(jk, f"metropolis_c{variant}_pallas{suffix}")


def _check_step(anc, stats, janc, jstats):
    jstats = np.asarray(jstats).reshape(stats.shape)
    stats = stats.numpy()
    np.testing.assert_array_equal(stats[..., 2], jstats[..., 2])  # same trigger
    np.testing.assert_allclose(stats[..., [0, 3]], jstats[..., [0, 3]], rtol=STATS_RTOL)
    np.testing.assert_allclose(stats[..., 1], jstats[..., 1], atol=INCR_ATOL, equal_nan=True)
    rate = (anc.numpy() != np.asarray(janc).reshape(anc.shape)).mean()
    assert rate <= MAX_MISMATCH_RATE


# ---------------------------------------------------------------- kernel level
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("kind,n,b", (("gamma", 3072, 16), ("subnormal", 4096, 1),
                                      ("tiny_normal", 8192, 16), ("subnormal", 3072, 16)))
def test_kernel_bits(variant, kind, n, b):
    """Rows 13-16: index-only and fused, one population."""
    w = _weights(kind, n)
    state = np.random.default_rng(2).normal(size=n).astype(np.float32)
    parts, seeds = _table(variant, n, b), _seeds(1)
    w2 = jnp.asarray(w.reshape(-1, 128))
    janc = _jax_kernel(variant, "index")(w2, jnp.asarray(parts), jnp.asarray(seeds),
                                         num_iters=b, interpret=True)
    jfanc, jout = _jax_kernel(variant, "fused")(
        w2, jnp.asarray(state.reshape(1, -1, 128)), jnp.asarray(parts), jnp.asarray(seeds),
        num_iters=b, interpret=True)
    seed = torch.tensor(int(seeds[0]))
    single = getattr(tk, f"metropolis_c{variant}")
    fused = getattr(tk, f"metropolis_c{variant}_fused")
    anc = single(torch.from_numpy(w), torch.from_numpy(parts), seed, b)
    fanc, got = fused(torch.from_numpy(w), torch.from_numpy(state)[None],
                      torch.from_numpy(parts), seed, b)
    np.testing.assert_array_equal(anc.numpy(), np.asarray(janc).reshape(n))
    np.testing.assert_array_equal(fanc.numpy(), anc.numpy())
    np.testing.assert_array_equal(_bits(got.numpy()[0]), _bits(np.asarray(jout).reshape(n)))
    # Every ancestor is the particle itself or lies in one of its tile's
    # partitions: one for C1, one per iteration for C2.
    i = np.arange(n)
    tiles_of_i = parts.reshape(n // 1024, -1)[i // 1024]
    assert ((anc.numpy() == i) | (anc.numpy()[:, None] // 1024 == tiles_of_i).any(1)).all()


@pytest.mark.parametrize("variant", VARIANTS)
def test_bank_kernels_are_rows_of_single(variant):
    """The bank forms: row ``s`` is the single kernel on row ``s`` of the
    weights, the table and the seeds."""
    s, n, b = 3, 3072, 8
    w = _weights("subnormal", (s, n), seed=1)
    state = np.random.default_rng(3).normal(size=(s, 2, n)).astype(np.float32)
    parts, seeds = _table(variant, n, b, rows=s, seed=1), _seeds(s, seed=1)
    tw, tp, ts = torch.from_numpy(w), torch.from_numpy(parts), torch.from_numpy(
        seeds.astype(np.int64))
    anc = getattr(tk, f"metropolis_c{variant}_batch")(tw, tp, ts, b)
    fanc, got = getattr(tk, f"metropolis_c{variant}_fused_batch")(tw, torch.from_numpy(state),
                                                                   tp, ts, b)
    for r in range(s):
        janc = _jax_kernel(variant, "index")(jnp.asarray(w[r].reshape(-1, 128)),
                                             jnp.asarray(parts[r]), jnp.asarray(seeds[r:r + 1]),
                                             num_iters=b, interpret=True)
        np.testing.assert_array_equal(anc[r].numpy(), np.asarray(janc).reshape(n))
    assert torch.equal(fanc, anc)
    assert torch.equal(got, torch.gather(torch.from_numpy(state), 2,
                                         anc.long()[:, None].expand(-1, 2, -1)))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("kind", ("normal", "ungm", "dead"))
@pytest.mark.parametrize("thr", (0.0, 0.5, 1.0))
def test_step_kernel(variant, kind, thr):
    """Rows 17-18."""
    n, b = 4096, 8
    lw = _log_weights(kind, n)
    state = np.random.default_rng(4).normal(size=n).astype(np.float32)
    parts, seeds = _table(variant, n, b, seed=2), _seeds(1, seed=2)
    k2, out, stats = _jax_kernel(variant, "step")(
        jnp.asarray(lw.reshape(-1, 128)), jnp.asarray(state.reshape(1, -1, 128)),
        jnp.asarray(parts), jnp.asarray(seeds), jnp.float32([thr]), num_iters=b,
        interpret=True)
    anc, got, st = getattr(tk, f"metropolis_c{variant}_step")(
        torch.from_numpy(lw), torch.from_numpy(state)[None], torch.from_numpy(parts),
        torch.tensor(int(seeds[0])), b, thr)
    _check_step(anc, st, k2, stats)
    np.testing.assert_array_equal(got.numpy()[0], state[anc.numpy()])


@pytest.mark.parametrize("variant", VARIANTS)
def test_ref_step_is_the_sweep_on_normalised_weights(variant):
    """The plain step's resample branch is the plain fused sweep on
    exp(lw - m), and the index-only sweep selects the same ancestors."""
    n, b = 3072, 8
    lw = torch.from_numpy(_log_weights("normal", (2, n), seed=27))
    state = torch.randn(2, 1, n, generator=torch.Generator().manual_seed(1))
    parts = torch.from_numpy(_table(variant, n, b, rows=2, seed=3))
    seeds = torch.tensor([5, 2**32 - 3])
    anc, out, stats = ref.metropolis_c1c2_step_rows_ref(lw, state, parts, seeds, b, 1.0,
                                                        variant)
    w = torch.exp(lw - lw.amax(dim=1, keepdim=True))
    anc2, out2 = ref.metropolis_c1c2_rows_ref(w, state, parts, seeds, b, variant)
    assert torch.equal(anc, anc2) and torch.equal(out, out2)
    assert torch.equal(ref.metropolis_c1c2_rows_ref(w, None, parts, seeds, b, variant), anc2)
    assert stats[:, 2].eq(1).all()


def test_wrappers_on_cpu_count_no_launch():
    tk.reset_launch_counts()
    n, b = 4096, 4
    w = torch.rand(2, n)
    seeds = torch.tensor([1, 2])
    for variant in VARIANTS:
        parts = torch.from_numpy(_table(variant, n, b, rows=2))
        c = f"metropolis_c{variant}"
        getattr(tk, c)(w[0], parts[0], torch.tensor(3), b)
        getattr(tk, c + "_batch")(w, parts, seeds, b)
        getattr(tk, c + "_fused")(w[0], w[:1], parts[0], torch.tensor(3), b)
        getattr(tk, c + "_fused_batch")(w, w[:, None], parts, seeds, b)
        getattr(tk, c + "_step")(w[0].log(), w[:1], parts[0], torch.tensor(3), b, 0.5)
        getattr(tk, c + "_step_rows")(w.log(), w[:, None], parts, seeds, b, 0.5)
    assert [fn.launches for fn in tk.WRAPPERS] == [0] * 12


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("bad", ("n", "width", "dtype", "range", "iters"))
def test_wrappers_validate(variant, bad):
    n = 1000 if bad == "n" else 4096
    b = 4
    w = torch.rand(2, n)
    parts = torch.zeros(2, 4 if variant == 1 else 16, dtype=torch.int32)
    if bad == "width":
        parts = torch.zeros(2, 16 if variant == 1 else 4, dtype=torch.int32)
    elif bad == "dtype":
        parts = parts.to(torch.int64)
    elif bad == "range":
        parts[1, 0] = 4
    with pytest.raises(ValueError):
        getattr(tk, f"metropolis_c{variant}_fused_batch")(w, w[:, None], parts,
                                                          torch.tensor([1, 2]),
                                                          0 if bad == "iters" else b)


# ----------------------------------------------------------------- entry level
def _resamplers(variant, b):
    jr = JAX_SPECS[variant](num_iters=b, partition_size_bytes=4096,
                            backend="pallas_interpret").build()
    return jr, convert.spec_from_jax(jr.spec).build()


def _keys(seed, rows=None):
    key = jax.random.PRNGKey(seed)
    if rows is not None:
        key = jax.random.split(key, rows)
    return key, convert.key_from_jax(jax.random.key_data(key))


#: Each entry at one of the shapes, so that N in {3072, 4096, 8192} and B in
#: {1, 16} are all crossed.
ENTRY_SHAPES = {"__call__": (3072, 16), "batch": (4096, 1), "batch_rows": (8192, 16),
                "apply": (8192, 1), "apply_batch": (3072, 16), "apply_rows": (4096, 16)}


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("entry", tuple(ENTRY_SHAPES))
def test_entries_bits(variant, entry):
    s = 3
    n, b = ENTRY_SHAPES[entry]
    jr, tr = _resamplers(variant, b)
    bank = entry not in ("__call__", "apply")
    w = _weights("subnormal" if variant == 1 else "gamma", (s, n) if bank else n, seed=9)
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


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("thr", (0.0, 0.5, 1.0))
def test_step_entry(variant, thr):
    jr, tr = _resamplers(variant, 16)
    lw = _log_weights("ungm", 8192, seed=13)
    p = np.random.default_rng(14).normal(size=8192).astype(np.float32)
    jkey, tkey = _keys(15)
    jp, ja, js = jr.step(jkey, jnp.asarray(lw), jnp.asarray(p), thr)
    tp, ta, ts = tr.step(tkey, torch.from_numpy(lw), torch.from_numpy(p), thr)
    _check_step(ta, torch.from_numpy(_stats_vec(ts, 0)), ja, _stats_vec(js, 0))
    np.testing.assert_array_equal(tp.numpy(), p[ta.numpy()])
    assert bool(ts.degenerate) == bool(js.degenerate)


@pytest.mark.parametrize("variant", VARIANTS)
def test_step_rows_entry(variant):
    """Each row its own trigger at threshold 0.5, a dead row on the uniform
    bank."""
    jr, tr = _resamplers(variant, 16)
    lws = np.stack([_log_weights(k, 3072, seed=i)
                    for i, k in enumerate(("normal", "ungm", "dead"))])
    ps = np.random.default_rng(16).normal(size=(3, 3072)).astype(np.float32)
    jkeys, tkeys = _keys(17, rows=3)
    jp, ja, js = jr.step_rows(jkeys, jnp.asarray(lws), jnp.asarray(ps), 0.5)
    tp, ta, ts = tr.step_rows(tkeys, torch.from_numpy(lws), torch.from_numpy(ps), 0.5)
    _check_step(ta, torch.from_numpy(_stats_vec(ts, -1)), ja, _stats_vec(js, -1))
    np.testing.assert_array_equal(ts.degenerate.numpy(), np.asarray(js.degenerate))


@pytest.mark.parametrize("variant", VARIANTS)
def test_step_on_reference_weights_equals_apply(variant):
    """The resample branch of the JAX step, fed through the port's apply
    with the weights JAX normalised, is bit-identical."""
    n, b = 4096, 16
    jr, tr = _resamplers(variant, b)
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
@pytest.mark.parametrize("variant", VARIANTS)
def test_bank_contracts(variant):
    """Split-key contract: ``batch``/``apply_batch`` row ``s`` is the single
    call with ``split(key, S)[s]``; explicit keys: ``batch_rows``/
    ``apply_rows`` row ``s`` is the single call with ``keys[s]``."""
    s, n = 4, 4096
    r = PORT_SPECS[variant](num_iters=8).build()
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
    other = r.batch_rows(trandom.split(trandom.fold_in(key, 1), s), w)
    assert not torch.equal(other, singles)


@pytest.mark.parametrize("variant", VARIANTS)
def test_auto_per_row(variant):
    """'auto' as the JAX kernel path resolves it: eq. (3) per row for every
    bank form; ``batch_rows`` raises ``TypeError`` on both sides."""
    s, n = 3, 4096
    jr = JAX_SPECS[variant](partition_size_bytes=4096, backend="pallas_interpret").build()
    tr = PORT_SPECS[variant]().build()
    # Rows of different concentration: eq. (3) gives them different B.
    w = np.stack([_weights("gamma", n, seed=32), np.ones(n, np.float32),
                  _weights("subnormal", n, seed=33)])
    jkey, tkey = _keys(34)
    np.testing.assert_array_equal(tr.batch(tkey, torch.from_numpy(w)).numpy(),
                                  np.asarray(jr.batch(jkey, jnp.asarray(w))))
    jkeys, tkeys = _keys(35, rows=s)
    with pytest.raises(TypeError):
        jr.batch_rows(jkeys, jnp.asarray(w))
    with pytest.raises(TypeError):
        tr.batch_rows(tkeys, torch.from_numpy(w))


# --------------------------------------------------------- spec and convert
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("field,value,err", (
    ("partition_size_bytes", 128, ValueError),
    ("partition_size_bytes", 2048, ValueError),
    ("partition_size_bytes", 0, ValueError),
    ("warp", 0, ValueError),
    ("backend", "reference", None),
    ("backend", "pallas", ValueError),
    ("backend", "tpu", ValueError),
    ("plane_dtype", "float64", ValueError),
    ("guard", "flag", None),
    ("num_iters", 0, ValueError),
))
def test_spec_validates(variant, field, value, err):
    if err is None:  # the reference backend and the guard build
        _builds_and_runs(PORT_SPECS[variant](num_iters=4, **{field: value}), field, value)
        return
    with pytest.raises(err):
        PORT_SPECS[variant](**{field: value})


def _builds_and_runs(spec, field, value):
    """A spec that validates builds, and its entry runs on the CPU."""
    r = spec.build()
    assert getattr(r.spec, field) == value
    anc = r(torch.zeros(2, dtype=torch.int64), torch.full((2048,), 1.0 / 2048))
    assert anc.shape == (2048,) and anc.dtype == torch.int32


@pytest.mark.parametrize("variant", VARIANTS)
def test_spec_defaults_and_partition_error(variant):
    spec = PORT_SPECS[variant]()
    assert (spec.partition_size_bytes, spec.warp, spec.backend) == (4096, 32, "cuda")
    with pytest.raises(ValueError, match="partition_size_bytes=4096"):
        PORT_SPECS[variant](partition_size_bytes=128)


@pytest.mark.parametrize("variant", VARIANTS)
def test_convert_spec_round_trip(variant):
    jcls, tcls = JAX_SPECS[variant], PORT_SPECS[variant]
    spec = convert.spec_from_jax(jcls(num_iters=32, partition_size_bytes=4096, warp=16,
                                      backend="pallas"))
    assert spec == tcls(num_iters=32, warp=16)
    assert convert.spec_from_jax(jcls(**convert.spec_to_jax(spec))) == spec
    assert convert.spec_from_jax(jcls(partition_size_bytes=4096,
                                      backend="pallas_interpret")) == tcls()
    # backend="reference" with the paper's 128-byte partitions: the port's reference
    assert convert.spec_from_jax(jcls(num_iters=8)) == \
        tcls(num_iters=8, partition_size_bytes=128, backend="reference")


# -------------------------------------------------------------- the repairs
@pytest.mark.parametrize("cls", (MegopolisSpec, MetropolisSpec, MetropolisC1Spec,
                                 MetropolisC2Spec))
def test_step_with_fixed_iters_does_not_normalise(cls, monkeypatch):
    """``step`` resolves eq. (3) only under 'auto': with an int num_iters no
    normalisation runs before the launch."""
    n = 4096
    lw = torch.from_numpy(_log_weights("normal", (2, n), seed=40))
    p = torch.randn(2, n, generator=torch.Generator().manual_seed(3))
    key = trandom.PRNGKey(41)
    auto = cls().build()
    fixed = cls(num_iters=8).build()

    def refuse(*args, **kwargs):
        raise AssertionError("normalise_log_weights ran under an int num_iters")

    monkeypatch.setattr(tspec, "normalise_log_weights", refuse)
    fixed.step(key, lw[0], p[0], 0.5)
    fixed.step_rows(trandom.split(key, 2), lw, p, 0.5)
    with pytest.raises(AssertionError, match="int num_iters"):
        auto.step(key, lw[0], p[0], 0.5)


# ---------------------------------------------------------------- the filter
N, T = 4096, 12


@pytest.fixture(scope="module")
def sim():
    key = jax.random.PRNGKey(1)
    xs, zs = jf.simulate(key, jm.ungm(), T)
    return key, np.array(xs), np.array(zs)


def _tkey(key):
    return convert.key_from_jax(jax.random.key_data(key))


@pytest.mark.parametrize("variant", VARIANTS)
def test_replay_alg6_bits(sim, variant):
    """The JAX Alg. 6 filter step by step; its pre-resample particles,
    weights and resample key go through the port's fused resample stage,
    which must return the same particles and ancestors bit for bit."""
    _, _, zs = sim
    b = 16
    model = jm.ungm()
    jpf = jf.ParticleFilter(model, N, resampler=JAX_SPECS[variant](
        num_iters=b, partition_size_bytes=4096, backend="pallas_interpret"))
    tpf = tf.ParticleFilter(tm.ungm(), N, resampler=PORT_SPECS[variant](num_iters=b))
    stage1 = jax.jit(lambda k, x, z, t: (lambda y: (y, model.likelihood(z, y, t)))(
        model.transition(k, x, t)))
    k0, k = jax.random.split(jax.random.PRNGKey(6 + variant))
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


@pytest.mark.parametrize("variant,thr,entry", ((1, None, "run_filter"),
                                               (1, 0.5, "run_filter_bank"),
                                               (2, None, "run_filter_bank"),
                                               (2, 0.5, "run_filter")))
def test_run_filter_matches(sim, variant, thr, entry, capsys):
    """Whole runs against JAX within ``WHOLE_RUN_ATOL``: each variant
    through one filter and a bank of 2, each mode through both."""
    key, _, zs = sim
    jspec = JAX_SPECS[variant](num_iters=16, partition_size_bytes=4096,
                               backend="pallas_interpret")
    jpf = jf.ParticleFilter(jm.ungm(), N, resampler=jspec, ess_threshold=thr)
    tpf = tf.ParticleFilter(tm.ungm(), N, resampler=convert.spec_from_jax(jspec),
                            ess_threshold=thr)
    obs = zs if entry == "run_filter" else np.stack([zs[:8], zs[:8] * 0.5])
    jest = getattr(jf, entry)(key, jpf, jnp.asarray(obs))
    test = getattr(tf, entry)(_tkey(key), tpf, torch.from_numpy(obs), device="cpu")
    assert test.shape == obs.shape
    with capsys.disabled():
        gap = float(np.abs(test.numpy() - np.asarray(jest)).max())
        print(f"\nmetropolis_c{variant} {entry} (threshold {thr}) vs JAX: "
              f"max |estimate gap| {gap:.3g}")
    np.testing.assert_allclose(test.numpy(), np.asarray(jest), atol=WHOLE_RUN_ATOL, rtol=0)


def test_particle_filter_takes_c1_and_c2():
    for cls in (MetropolisC1Spec, MetropolisC2Spec):
        assert tf.ParticleFilter(tm.ungm(), N, resampler=cls(num_iters=4)).spec == cls(
            num_iters=4)


def test_tables_follow_the_jax_wrappers():
    """The partition tables and seeds of ``c1c2_tables`` are those
    ``metropolis_c{1,2}_tpu`` draw from the same key."""
    from repro.kernels.common import key_to_seed as jax_key_to_seed

    n, b = 8192, 16
    jkey, tkey = _keys(50)
    kp, kloop = jax.random.split(jkey)
    for variant, width in ((1, 8), (2, 8 * b)):
        parts, seed = tops.c1c2_tables(variant, tkey, n, b, "cpu")
        want = jax.random.randint(kp, (width,), 0, 8, dtype=jnp.int32)
        np.testing.assert_array_equal(parts.numpy(), np.asarray(want))
        assert int(seed) == int(jax_key_to_seed(kloop))
