"""Compressed planes (DESIGN.md §14, ``plane_dtype`` bfloat16 / float16) of
the Metropolis-C1/C2 and rejection families in the port against the JAX
package, on the CPU (the kernels' plain versions against the Pallas kernels
in interpret mode).

* Every entry of C1, C2 and rejection at both dtypes: the ancestors equal
  JAX's bit for bit, so do the particles of ``apply`` and ``step``; the
  step's stats are held to ``STATS_RTOL``/``INCR_ATOL``, the bounds of
  ``test_torch_plane_dtype.py``.
* ``r_dt(key, w) == r_f32(key, r_dt.quantise(w))``, index only and fused.
* Weights with float32 subnormals (flushed on both sides) and values below
  float16's smallest normal and smallest subnormal give JAX's ancestors.
* The C1/C2 partition stays one tile of 1024 particles at every dtype
  (``partition_size_bytes`` 4096).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.spec import MetropolisC1Spec as JaxC1Spec
from repro.core.spec import MetropolisC2Spec as JaxC2Spec
from repro.core.spec import RejectionSpec as JaxRejectionSpec
from repro_torch.convert import key_from_jax, spec_from_jax
from repro_torch.core.spec import MetropolisC1Spec, MetropolisC2Spec, RejectionSpec
from repro_torch.kernels import common as tc

N, B, S, D = 2048, 8, 2, 2
MAX_ITERS = 64
DTYPES = ("bfloat16", "float16")
FAMILIES = {
    "metropolis_c1": (JaxC1Spec, MetropolisC1Spec,
                      {"num_iters": B, "partition_size_bytes": 4096}),
    "metropolis_c2": (JaxC2Spec, MetropolisC2Spec,
                      {"num_iters": B, "partition_size_bytes": 4096}),
    "rejection": (JaxRejectionSpec, RejectionSpec, {"max_iters": MAX_ITERS}),
}
ENTRIES = ("__call__", "batch", "batch_rows", "apply", "apply_batch", "apply_rows", "step",
           "step_rows")
STATS_RTOL = 2e-6
INCR_ATOL = 2e-6


@pytest.fixture(autouse=True)
def _partitionable():
    assert jax.config.jax_threefry_partitionable


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int16 if x.itemsize == 2 else np.int32)


def _inputs(entry: str, seed: int):
    rng = np.random.default_rng(seed)
    bank = entry not in ("__call__", "apply", "step")
    shape = (S, N) if bank else (N,)
    if entry.startswith("step"):
        w = (-0.5 * rng.uniform(0, 10, size=shape) ** 2).astype(np.float32)
    else:
        w = rng.gamma(0.5, size=shape).astype(np.float32)
        w.reshape(-1)[::97] = np.float32(1e-39)  # flushed on both sides
    p = rng.normal(size=shape + (D,)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    if entry.endswith("_rows"):
        key = jax.random.split(key, S)
    return w, p, key, key_from_jax(jax.random.key_data(key))


def _pair(family: str, dtype: str):
    jcls, _, fields = FAMILIES[family]
    jr = jcls(backend="pallas_interpret", plane_dtype=dtype, **fields).build()
    return jr, spec_from_jax(jr.spec).build()


def _call(r, entry, key, w, p, lib):
    if entry in ("__call__", "batch", "batch_rows"):
        fn = r if entry == "__call__" else getattr(r, entry)
        return (fn(key, lib(w)),)
    if entry.startswith("apply"):
        return getattr(r, entry)(key, lib(w), lib(p))
    return getattr(r, entry)(key, lib(w), lib(p), 0.9)


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family", FAMILIES)
def test_entries_match_jax(family, dtype, entry):
    jr, tr = _pair(family, dtype)
    assert tr.plane_dtype == dtype
    w, p, jkey, tkey = _inputs(entry, seed=len(entry) + 10 * len(family))
    want = _call(jr, entry, jkey, w, p, jnp.asarray)
    got = _call(tr, entry, tkey, w, p, torch.from_numpy)
    anc = got[0] if len(got) == 1 else got[1]
    janc = want[0] if len(want) == 1 else want[1]
    np.testing.assert_array_equal(anc.numpy(), np.asarray(janc))
    if len(got) == 1:
        return
    assert got[0].dtype == torch.float32 and got[0].shape == p.shape
    np.testing.assert_array_equal(_bits(got[0].numpy()), _bits(np.asarray(want[0])))
    if entry.startswith("step"):
        ts, js = got[2], want[2]
        for field in ("ess_norm", "max_weight"):
            np.testing.assert_allclose(getattr(ts, field).numpy(),
                                       np.asarray(getattr(js, field)), rtol=STATS_RTOL)
        np.testing.assert_allclose(ts.log_evidence_incr.numpy(),
                                   np.asarray(js.log_evidence_incr), atol=INCR_ATOL)
        np.testing.assert_array_equal(ts.resampled.numpy(), np.asarray(js.resampled))
        assert bool(ts.resampled.all()), "the inputs must resample"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family", FAMILIES)
def test_compressed_equals_f32_on_quantised(family, dtype):
    """``r_dt(key, w) == r_f32(key, r_dt.quantise(w))``, index only and
    fused (the particles too, in the caller's dtype)."""
    _, cls, fields = FAMILIES[family]
    r16, r32 = cls(plane_dtype=dtype, **fields).build(), cls(**fields).build()
    w, p, _, key = _inputs("apply", seed=3)
    w, p = torch.from_numpy(w), torch.from_numpy(p)
    assert torch.equal(r16(key, w), r32(key, r16.quantise(w)))
    p16, a16 = r16.apply(key, w, p)
    p32, a32 = r32.apply(key, r16.quantise(w), r16.quantise(p))
    assert torch.equal(a16, a32) and torch.equal(p16, p32) and p16.dtype == p.dtype


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family", FAMILIES)
def test_tiny_weights_match_jax(family, dtype):
    """Float32 subnormals (flushed on both sides) and weights below float16's
    smallest normal (float16 subnormals, normal again in float32) and
    smallest subnormal (zero at float16)."""
    rng = np.random.default_rng(5)
    w = (rng.uniform(1.0, 4.0, size=N) * 1e-5).astype(np.float32)
    w[::5] = np.float32(1e-39)
    w[1::5] = np.float32(2e-8)
    w[2::5] *= np.float32(4.0)
    p = rng.normal(size=(N, D)).astype(np.float32)
    jr, tr = _pair(family, dtype)
    key = jax.random.PRNGKey(6)
    tkey = key_from_jax(jax.random.key_data(key))
    jp, ja = jr.apply(key, jnp.asarray(w), jnp.asarray(p))
    tp, ta = tr.apply(tkey, torch.from_numpy(w), torch.from_numpy(p))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(_bits(tp.numpy()), _bits(np.asarray(jp)))
    np.testing.assert_array_equal(tr(tkey, torch.from_numpy(w)).numpy(), np.asarray(ja))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cls", (MetropolisC1Spec, MetropolisC2Spec))
def test_partition_stays_one_tile(cls, dtype):
    """The partition is 4096 bytes, one tile of 1024 particles, at every
    plane dtype, as in the JAX package; another size raises."""
    assert cls(plane_dtype=dtype).partition_size_bytes == 4096
    with pytest.raises(ValueError, match="partition_size_bytes"):
        cls(plane_dtype=dtype, partition_size_bytes=2048)


@pytest.mark.parametrize("dtype", DTYPES)
def test_wrappers_take_planes_on_cpu(dtype):
    """The plain versions take 2-byte planes, return state of the plane
    dtype and count no launch; the census names follow the word."""
    from repro_torch.kernels.metropolis import c1c2 as ck
    from repro_torch.kernels.rejection import rejection as rk

    dt = getattr(torch, dtype)
    w = torch.rand(2, N).to(dt)
    state = torch.randn(2, D, N).to(dt)
    parts = torch.randint(0, N // 1024, (2, N // 1024 * B), dtype=torch.int32)
    seeds = torch.tensor([3, 4])
    ck.reset_launch_counts()
    rk.reset_launch_counts()
    anc, out = ck.metropolis_c2_fused_batch(w, state, parts, seeds, B)
    anc2, out2 = rk.rejection_fused_batch(w, state, seeds, MAX_ITERS)
    for a, o in ((anc, out), (anc2, out2)):
        assert o.dtype == dt and a.dtype == torch.int32
        assert torch.equal(o, torch.gather(state, 2, a.long()[:, None].expand_as(state)))
    assert ck.metropolis_c2_fused_batch.launches == rk.rejection_fused_batch.launches == 0
    word = tc.PLANE_WORDS[dt]
    assert tc.plane_instance("metropolis_c1c2_rows_kernel", 2, True, state=1)(w, state) == \
        f"metropolis_c1c2_rows_kernel<2, true, {word}, unsigned short>"
    assert tc.plane_instance("rejection_step_rows_kernel", state=1)(w, state) == \
        f"rejection_step_rows_kernel<{word}, unsigned short>"
