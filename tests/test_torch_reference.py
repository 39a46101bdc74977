"""The port's reference backend and name registry against the JAX package's,
on the CPU.

* Every entry of every family name on ``backend="reference"`` (Megopolis at
  ``segment=32``, C1/C2 at 128-byte partitions, ``spec_for_backend``'s
  geometry) at float32 and bfloat16 planes: the ancestors equal JAX's
  ``backend="reference"`` bit for bit, and so do the particles of
  ``apply`` and ``step``; the step's stats are held to ``STATS_RTOL`` /
  ``INCR_ATOL`` (torch sums in another order than XLA).
* 'auto' (eq. (3), B capped at ``AUTO_MAX_ITERS``): Megopolis's own offset
  stream and the Metropolis family's, bit for bit.
* The reference resamplers of ``core/resamplers`` at lengths that are no
  multiple of 16 or 32: ``xla_cumsum`` is ``jnp.cumsum``'s order, and the
  legacy ``get_resampler`` functions are JAX's.
* Residual normalises by ``xla_sum``, XLA-CPU's tree reduction in windows of
  32; the share of lengths where it equals ``jnp.sum`` is held, not 1.
* The registry behaves as the JAX package's on the cases its tests pin
  (``tests/test_backend_parity.py``, ``tests/test_spec.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import spec as jspec
from repro.core.resamplers import get_resampler as jax_get_resampler
from repro.core.resamplers import get_resampler_batch as jax_get_resampler_batch
from repro_torch import random as trandom
from repro_torch.convert import key_from_jax
from repro_torch.core import spec
from repro_torch.core.resamplers import prefix_sum as tprefix
from repro_torch.pf.filter import ParticleFilter
from repro_torch.pf.models import ungm

N, B, S, D = 1000, 8, 2, 2
MAX_ITERS = 64
THR = 0.5
NAMES = tuple(jspec.list_resamplers())
ENTRIES = ("__call__", "batch", "batch_rows", "apply", "apply_batch", "apply_rows", "step",
           "step_rows")
STATS_RTOL = 2e-6
INCR_ATOL = 2e-6
#: Share of lengths at which ``xla_sum`` equals ``jnp.sum`` (24 of 30 measured
#: on jax 0.9.0's CPU backend): held at two thirds.
SUM_MATCH_SHARE = 2 / 3


@pytest.fixture(autouse=True)
def _partitionable():
    assert jax.config.jax_threefry_partitionable


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _specs(name, plane_dtype="float32", num_iters=B):
    kw = dict(num_iters=num_iters, max_iters=MAX_ITERS, plane_dtype=plane_dtype)
    return (jspec.spec_for_backend(name, "reference", **kw).build(),
            spec.spec_for_backend(name, "reference", **kw).build())


def _inputs(entry: str, seed: int):
    rng = np.random.default_rng(seed)
    bank = entry not in ("__call__", "apply", "step")
    shape = (S, N) if bank else (N,)
    if entry.startswith("step"):
        w = (rng.standard_normal(shape) * 3.0).astype(np.float32)  # log-weights
    else:
        w = rng.gamma(0.5, size=shape).astype(np.float32)
    p = rng.standard_normal(shape + (D,)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    keys = jax.random.split(key, S)
    return w, p, key, keys


def _call(r, entry, key, keys, w, p, jax_side: bool):
    conv = jnp.asarray if jax_side else torch.from_numpy
    k = key if jax_side else key_from_jax(jax.random.key_data(key))
    ks = keys if jax_side else key_from_jax(jax.random.key_data(keys))
    w, p = conv(w), conv(p)
    return {
        "__call__": lambda: r(k, w),
        "batch": lambda: r.batch(k, w),
        "batch_rows": lambda: r.batch_rows(ks, w),
        "apply": lambda: r.apply(k, w, p),
        "apply_batch": lambda: r.apply_batch(k, w, p),
        "apply_rows": lambda: r.apply_rows(ks, w, p),
        "step": lambda: r.step(k, w, p, THR),
        "step_rows": lambda: r.step_rows(ks, w, p, THR),
    }[entry]()


def _hold(entry, want, got):
    if entry in ("__call__", "batch", "batch_rows"):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        return
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(_bits(got[0].numpy()), _bits(want[0]))
    if entry.startswith("step"):
        js, ts = want[2], got[2]
        for field in ("ess_norm", "max_weight", "resampled"):
            np.testing.assert_allclose(getattr(ts, field).numpy(), np.asarray(getattr(js, field)),
                                       rtol=STATS_RTOL)
        np.testing.assert_allclose(ts.log_evidence_incr.numpy(),
                                   np.asarray(js.log_evidence_incr), atol=INCR_ATOL)
        np.testing.assert_array_equal(ts.survivors.numpy(), np.asarray(js.survivors))
        np.testing.assert_array_equal(ts.degenerate.numpy(), np.asarray(js.degenerate))


@pytest.mark.parametrize("plane_dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("name", NAMES)
def test_reference_entries_match_jax(name, plane_dtype):
    jr, tr = _specs(name, plane_dtype)
    assert tr.spec.backend == "reference" and tr.name == name
    for i, entry in enumerate(ENTRIES):
        w, p, key, keys = _inputs(entry, 10 + i)
        want = _call(jr, entry, key, keys, w, p, jax_side=True)
        got = _call(tr, entry, key, keys, w, p, jax_side=False)
        _hold(entry, want, got)


@pytest.mark.parametrize("name", ("megopolis", "metropolis", "metropolis_c1", "metropolis_c2"))
def test_reference_auto_matches_jax(name):
    """'auto': B from eq. (3) per call, capped at AUTO_MAX_ITERS; Megopolis
    draws its offsets at that cap (a stream of its own)."""
    assert spec.AUTO_MAX_ITERS == jspec.AUTO_MAX_ITERS
    jr, tr = _specs(name, num_iters="auto")
    for i, entry in enumerate(("__call__", "batch", "apply_rows", "step")):
        w, p, key, keys = _inputs(entry, 40 + i)
        _hold(entry, _call(jr, entry, key, keys, w, p, True),
              _call(tr, entry, key, keys, w, p, False))


@pytest.mark.parametrize("segment", (1, 32, 1024))
def test_megopolis_segments_and_shared_offsets(segment):
    from repro.core.resamplers import megopolis_batch as jax_megopolis_batch
    from repro_torch.core.resamplers import megopolis_batch

    w, _, key, _ = _inputs("batch", 50)
    tkey = key_from_jax(jax.random.key_data(key))
    for shared in (False, True):
        want = jax_megopolis_batch(key, jnp.asarray(w), B, segment=segment,
                                   shared_offsets=shared)
        got = megopolis_batch(tkey, torch.from_numpy(w), B, segment=segment,
                              shared_offsets=shared)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("psb,warp", ((64, 16), (128, 32), (4096, 32)))
def test_partitioned_reference_any_partition(psb, warp):
    for name in ("metropolis_c1", "metropolis_c2"):
        kw = dict(num_iters=B, partition_size_bytes=psb, warp=warp, backend="reference")
        jr = jspec.spec_from_name(name, **kw).build()
        tr = spec.spec_from_name(name, **kw).build()
        w, p, key, keys = _inputs("apply_rows", 60)
        _hold("apply_rows", _call(jr, "apply_rows", key, keys, w, p, True),
              _call(tr, "apply_rows", key, keys, w, p, False))


@pytest.mark.parametrize("n", (1, 5, 16, 17, 100, 1023, 5000))
def test_xla_cumsum_is_jnp_cumsum(n):
    x = np.random.default_rng(n).random(n).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(x)))
    np.testing.assert_array_equal(_bits(tprefix.xla_cumsum(torch.from_numpy(x)).numpy()),
                                  _bits(want))


def test_xla_sum_share():
    """``xla_sum`` against ``jnp.sum`` over 30 lengths: the share that
    agree bit for bit (the rest differ by an ULP or a few)."""
    rng = np.random.default_rng(0)
    hits = []
    for trial in range(30):
        n = int(rng.integers(100, 70000)) if trial % 2 else 4096
        x = rng.random(n).astype(np.float32)
        want = np.asarray(jnp.sum(jnp.asarray(x)))
        got = tprefix.xla_sum(torch.from_numpy(x)).numpy()
        hits.append(bool(got == want))
        assert abs(float(got) - float(want)) <= 8 * np.spacing(np.float32(want))
    print(f"xla_sum == jnp.sum at {sum(hits)} of {len(hits)} lengths")
    assert sum(hits) >= SUM_MATCH_SHARE * len(hits)


@pytest.mark.parametrize("side", ("left", "right"))
def test_searchsorted_is_jnp_searchsorted(side):
    rng = np.random.default_rng(1)
    a = np.sort(rng.random(300).astype(np.float32))
    a[[10, 11, 12]] = a[10]  # ties
    a[-3:] = np.nan  # NaN sorts last
    q = np.concatenate([rng.random(200).astype(np.float32), a[:20], [np.nan, -0.0, 0.0, 2.0]])
    q = q.astype(np.float32)
    want = np.asarray(jnp.searchsorted(jnp.asarray(a), jnp.asarray(q), side=side))
    got = tprefix.searchsorted(torch.from_numpy(a), torch.from_numpy(q), side)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", NAMES)
def test_legacy_lookups_are_the_reference_functions(name):
    w, _, key, _ = _inputs("batch", 70)
    tkey = key_from_jax(jax.random.key_data(key))
    kw = {"max_iters": MAX_ITERS} if name == "rejection" else {}
    want = jax_get_resampler(name)(key, jnp.asarray(w[0]), B, **kw)
    got = spec.get_resampler(name)(tkey, torch.from_numpy(w[0]), B, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jax_get_resampler_batch(name)(key, jnp.asarray(w), B, **kw)
    got = spec.get_resampler_batch(name)(tkey, torch.from_numpy(w), B, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_reference_flushes_subnormal_weights():
    """Weights with subnormals: flushed on both sides (XLA on the CPU)."""
    w, _, key, _ = _inputs("__call__", 80)
    w[::7] = np.float32(1e-40)
    for name in ("megopolis", "metropolis", "rejection", "multinomial", "residual"):
        jr, tr = _specs(name)
        np.testing.assert_array_equal(
            tr(key_from_jax(jax.random.key_data(key)), torch.from_numpy(w)).numpy(),
            np.asarray(jr(key, jnp.asarray(w))))


# ---------------------------------------------------------- the registry
def test_registry_names_and_lookup():
    assert spec.list_resamplers() == list(jspec.list_resamplers())
    assert spec.spec_from_name("megopolis", num_iters=24) == spec.MegopolisSpec(num_iters=24)
    assert spec.spec_from_name("residual") == spec.PrefixSumSpec(kind="residual")
    with pytest.raises(KeyError, match="did you mean 'megopolis'"):
        spec.spec_from_name("megopolys")
    with pytest.raises(KeyError, match="did you mean 'megopolis'"):
        spec.get_resampler("megopolys")


def test_spec_from_name_kwargs():
    # num_iters is dropped on the families without one; others raise.
    assert spec.spec_from_name("systematic", num_iters=8) == spec.PrefixSumSpec()
    assert spec.spec_from_name("rejection", num_iters=8) == spec.RejectionSpec()
    with pytest.raises(TypeError, match="unknown spec argument"):
        spec.spec_from_name("metropolis", segment=32)
    with pytest.raises(TypeError, match="unknown spec argument"):
        spec.spec_from_name("systematic", max_iters=8)


def test_coerce_spec_filters_defaults_by_field():
    assert spec.coerce_spec("megopolis", num_iters=7, segment=32, backend="reference") == \
        spec.MegopolisSpec(num_iters=7, segment=32, backend="reference")
    assert spec.coerce_spec("systematic", num_iters=7, segment=32) == spec.PrefixSumSpec()
    s = spec.MetropolisC1Spec(num_iters=4)
    assert spec.coerce_spec(s, num_iters=9, max_iters=3) == s.replace(num_iters=9)
    assert spec.coerce_spec(s) is s
    with pytest.raises(TypeError):
        spec.coerce_spec(3)


@pytest.mark.parametrize("backend", spec.BACKENDS)
@pytest.mark.parametrize("name", NAMES)
def test_spec_for_backend_every_cell_builds(name, backend):
    s = spec.spec_for_backend(name, backend, guard="recover")
    r = s.build()
    assert (r.name, s.backend, s.guard) == (name, backend, "recover")
    j = jspec.spec_for_backend(name, "pallas" if backend == "cuda" else backend)
    for field in ("segment", "partition_size_bytes", "num_iters", "max_iters", "kind"):
        assert getattr(s, field, None) == getattr(j, field, None), field


@pytest.mark.parametrize("jax_backend,port", (("xla", "reference"), ("pallas", "cuda"),
                                              ("pallas_interpret", "cuda")))
def test_jax_backends_name_their_counterpart(jax_backend, port):
    for cls in (spec.MegopolisSpec, spec.MetropolisSpec, spec.RejectionSpec,
                spec.PrefixSumSpec, spec.MetropolisC1Spec):
        with pytest.raises(ValueError, match=f"backend='{port}'"):
            cls(backend=jax_backend)


def test_launch_budgets_by_backend():
    for name, backend, entry in spec.contract_cells():
        want = jspec.launch_budget(name, "pallas" if backend == "cuda" else backend, entry)
        assert spec.launch_budget(name, backend, entry) == want
    assert len(list(spec.contract_cells())) == 10 * 2 * 8
    with pytest.raises(KeyError):
        spec.launch_budget("megopolis", "xla", "call")
    with pytest.raises(KeyError, match="did you mean 'residual'"):
        list(spec.contract_cells(families=("residul",)))


def test_particle_filter_takes_a_name_on_both_backends():
    pf = ParticleFilter(ungm(), 1024, resampler="residual")
    assert pf.spec == spec.PrefixSumSpec(kind="residual")
    ref = ParticleFilter(ungm(), 1024,
                         resampler=spec.coerce_spec("megopolis", backend="reference",
                                                    segment=32, num_iters=8))
    assert ref.spec.backend == "reference"
    from repro_torch.pf.filter import run_filter

    est = run_filter(trandom.PRNGKey(0), ref, torch.zeros(3), device="cpu")
    assert est.shape == (3,) and bool(torch.isfinite(est).all())


@pytest.mark.parametrize("n,sample", ((1000, 4096), (20000, 4096), (20000, 64)))
def test_select_iterations_subsample_matches_jax(n, sample):
    from repro.core.iterations import select_iterations_subsample as jax_subsample
    from repro_torch.core.iterations import select_iterations_subsample

    w = np.random.default_rng(n + sample).gamma(0.5, size=n).astype(np.float32)
    key = jax.random.PRNGKey(sample)
    want = int(jax_subsample(key, jnp.asarray(w), 0.01, sample))
    got = select_iterations_subsample(key_from_jax(jax.random.key_data(key)),
                                      torch.from_numpy(w), 0.01, sample)
    assert isinstance(got, int) and got == want
