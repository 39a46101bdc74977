"""Compressed planes (DESIGN.md §14, ``plane_dtype`` bfloat16 / float16) of
the prefix-sum family in the port against the JAX package, on the CPU (the
kernels' plain versions against the Pallas kernels in interpret mode).

Only the first scan's input travels compressed; the CDF, the draws and
residual's counts and residuals are float32 on both sides.

* Every entry of the five kinds at both dtypes: the ancestors equal JAX's
  bit for bit, so do the particles of ``apply`` and ``step``; the step's
  stats are held to ``STATS_RTOL``/``INCR_ATOL``, the bounds of
  ``test_torch_plane_dtype.py``.
* ``r_dt(key, w) == r_f32(key, r_dt.quantise(w))``, index only and fused.
* Weights with float32 subnormals and values below float16's smallest
  normal and smallest subnormal give JAX's ancestors.
* Residual's host arithmetic (``w / total``, the counts and residuals) runs
  on the weights upcast to float32: on weights where the same arithmetic in
  the plane dtype gives other counts, the port equals JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.spec import PrefixSumSpec as JaxPrefixSumSpec
from repro_torch.convert import key_from_jax, spec_from_jax
from repro_torch.core.spec import PrefixSumSpec
from repro_torch.kernels import common as tc
from repro_torch.kernels.prefix_sum import ops as pops
from repro_torch.kernels.prefix_sum import ref as pref

N, S, D = 2048, 2, 2
DTYPES = ("bfloat16", "float16")
KINDS = ("multinomial", "systematic", "improved_systematic", "stratified", "residual")
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


def _pair(kind: str, dtype: str):
    jr = JaxPrefixSumSpec(kind=kind, backend="pallas_interpret", plane_dtype=dtype).build()
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
@pytest.mark.parametrize("kind", KINDS)
def test_entries_match_jax(kind, dtype, entry):
    jr, tr = _pair(kind, dtype)
    assert tr.plane_dtype == dtype
    w, p, jkey, tkey = _inputs(entry, seed=len(entry) + 10 * len(kind))
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
@pytest.mark.parametrize("kind", KINDS)
def test_compressed_equals_f32_on_quantised(kind, dtype):
    """``r_dt(key, w) == r_f32(key, r_dt.quantise(w))``, index only and
    fused (the particles too, in the caller's dtype)."""
    r16 = PrefixSumSpec(kind=kind, plane_dtype=dtype).build()
    r32 = PrefixSumSpec(kind=kind).build()
    w, p, _, key = _inputs("apply", seed=3)
    w, p = torch.from_numpy(w), torch.from_numpy(p)
    assert torch.equal(r16(key, w), r32(key, r16.quantise(w)))
    p16, a16 = r16.apply(key, w, p)
    p32, a32 = r32.apply(key, r16.quantise(w), r16.quantise(p))
    assert torch.equal(a16, a32) and torch.equal(p16, p32) and p16.dtype == p.dtype


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_tiny_weights_match_jax(kind, dtype):
    """Float32 subnormals (flushed on both sides) and weights below float16's
    smallest normal (float16 subnormals, normal again in float32) and
    smallest subnormal (zero at float16)."""
    rng = np.random.default_rng(5)
    w = (rng.uniform(1.0, 4.0, size=N) * 1e-5).astype(np.float32)
    w[::5] = np.float32(1e-39)
    w[1::5] = np.float32(2e-8)
    w[2::5] *= np.float32(4.0)
    p = rng.normal(size=(N, D)).astype(np.float32)
    jr, tr = _pair(kind, dtype)
    key = jax.random.PRNGKey(6)
    tkey = key_from_jax(jax.random.key_data(key))
    jp, ja = jr.apply(key, jnp.asarray(w), jnp.asarray(p))
    tp, ta = tr.apply(tkey, torch.from_numpy(w), torch.from_numpy(p))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(_bits(tp.numpy()), _bits(np.asarray(jp)))
    np.testing.assert_array_equal(tr(tkey, torch.from_numpy(w)).numpy(), np.asarray(ja))


@pytest.mark.parametrize("dtype", DTYPES)
def test_residual_host_arithmetic_is_f32(dtype):
    """Residual on weights whose split ``N·w/total`` taken in the plane dtype
    gives other counts than in float32 (so a host step left in 2 bytes would
    show): the port's ancestors equal JAX's, index only and fused, and its
    split is the float32 one of the quantised weights."""
    # Ones, some halves, and a few weights just below 3·total/N on both
    # 2-byte grids: N·w/total rounds up to 3 in 2 bytes, stays below in f32.
    rng = np.random.default_rng(11)
    w = np.ones(N, np.float32)
    w[:14] = 0.5
    w[14:18] = 2.984375
    rng.shuffle(w)
    dt = getattr(torch, dtype)
    w2 = torch.from_numpy(w).to(dt)
    total = pref.scan_rows_ref(w2[None])[:, -1]
    counts32, _, n_det32 = pref.residual_parts(w2[None].float(), total)
    counts2 = torch.floor(w2[None] / total.to(dt) * N).float()
    assert not torch.equal(counts2, counts32), "the weights must tell the two apart"
    jr, tr = _pair("residual", dtype)
    key = jax.random.PRNGKey(12)
    tkey = key_from_jax(jax.random.key_data(key))
    np.testing.assert_array_equal(tr(tkey, torch.from_numpy(w)).numpy(),
                                  np.asarray(jr(key, jnp.asarray(w))))
    p = rng.normal(size=(N, D)).astype(np.float32)
    jp, ja = jr.apply(key, jnp.asarray(w), jnp.asarray(p))
    tp, ta = tr.apply(tkey, torch.from_numpy(w), torch.from_numpy(p))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(_bits(tp.numpy()), _bits(np.asarray(jp)))
    cc, c, u, n_det = pops._residual_scans(tkey[None], w2[None])
    assert torch.equal(n_det, n_det32) and cc.dtype == c.dtype == u.dtype == torch.float32
    assert torch.equal(cc, pref.scan_rows_ref(counts32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_draws_are_f32(kind, dtype):
    """The draws and the CDF are float32 whatever the weights' plane dtype,
    and the same bits as at float32 on the quantised weights."""
    dt = getattr(torch, dtype)
    w = torch.rand(S, N)
    keys = key_from_jax(jax.random.key_data(jax.random.split(jax.random.PRNGKey(4), S)))
    ubase, u0 = pops.draw_bases(keys, N, kind, w.device)
    assert (ubase if u0 is None else u0).dtype == torch.float32
    c16 = pops.prefix_sum_rows(w.to(dt))
    assert c16.dtype == torch.float32
    assert torch.equal(c16, pops.prefix_sum_rows(tc.quantise_plane(w, dtype)))
    if kind != "residual":
        u16, side = pops.kind_draws(keys, N, c16[:, -1], kind)
        u32, _ = pops.kind_draws(keys, N, pops.prefix_sum_rows(w.to(dt).float())[:, -1], kind)
        assert u16.dtype == torch.float32 and torch.equal(u16, u32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_wrappers_take_planes_on_cpu(dtype):
    """The plain versions take 2-byte planes where the kernels do (the scan's
    input, the searches' state, the step's log-weights and state) and count
    no launch; the census names follow the word."""
    from repro_torch.kernels.prefix_sum import prefix_sum as pk
    from repro_torch.kernels.prefix_sum import search as sk
    from repro_torch.kernels.prefix_sum import step as stk

    dt = getattr(torch, dtype)
    w = torch.rand(S, N).to(dt)
    state = torch.randn(S, D, N).to(dt)
    for m in (pk, sk, stk):
        m.reset_launch_counts()
    c = pk.prefix_sum_rows(w)
    u = torch.rand(S, N) * c[:, -1:]
    anc, out = sk.searchsorted_gather_rows(c, u, state, "right", False)
    assert c.dtype == torch.float32 and out.dtype == dt and anc.dtype == torch.int32
    assert torch.equal(out, torch.gather(state, 2, anc.long()[:, None].expand_as(state)))
    anc2, out2, stats = stk.prefix_step_rows(torch.log(w.float()).to(dt), state, u / c[:, -1:],
                                             None, 0.9, "multinomial")
    assert out2.dtype == dt and stats.dtype == torch.float32
    assert pk.prefix_sum_rows.launches == sk.searchsorted_gather_rows.launches == 0
    assert stk.prefix_step_rows.launches == 0
    word = tc.PLANE_WORDS[dt]
    names = {
        "scan": tc.plane_instance("prefix_scan_rows_kernel")(w),
        "gather": sk._kernel(True)(c, u, state, "right", False),
        "rising": sk._kernel(True)(c, u, state, "left", True),
        "index": sk._kernel(False)(c, u, "left", True),
        "step": stk._step_kernel(w, state, u, None, 0.9, "residual"),
    }
    assert names == {
        "scan": f"prefix_scan_rows_kernel<{word}>",
        "gather": "prefix_search_tree_kernel<true, false, unsigned short>",
        "rising": "prefix_search_rows_kernel<true, unsigned short>",
        "index": "prefix_search_rows_kernel<false, unsigned int>",
        "step": f"prefix_step_rows_kernel<3, {word}, unsigned short>",
    }
    with pytest.raises(ValueError, match="float32"):
        sk.searchsorted_rows(c.to(dt), u, "left")
