"""Compressed planes (DESIGN.md §14, ``plane_dtype`` bfloat16 / float16) in
the port against the JAX package, on the CPU (the kernels' plain versions
against the Pallas kernels in interpret mode).

* ``quantise_plane`` / ``compress_plane`` give JAX's bits at both 2-byte
  dtypes, and pass int tensors through.
* The spec surface: every family takes bfloat16 and float16 and refuses
  float64 (C1, C2, rejection and the prefix-sum kinds against the JAX
  package: ``test_torch_plane_dtype_c1c2_rejection.py``,
  ``test_torch_plane_dtype_prefix.py``).
* Every entry of both families at both dtypes: the ancestors equal JAX's
  bit for bit, so do the particles of ``apply``; the step's stats are held
  to ``STATS_RTOL``/``INCR_ATOL`` (ROADMAP Queue C item 3: the sums run in
  another order) and its particles to the ancestors' state.
* ``r_bf16(key, w) == r_f32(key, r_bf16.quantise(w))``.
* Weights with float32 subnormals and values below float16's smallest
  normal give JAX's ancestors at both dtypes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.spec import MegopolisSpec as JaxMegopolisSpec
from repro.core.spec import MetropolisSpec as JaxMetropolisSpec
from repro.kernels import common as jc
from repro_torch.analysis.contracts import audit_matrix
from repro_torch.convert import key_from_jax, spec_from_jax
from repro_torch.core.spec import (
    MegopolisSpec,
    MetropolisC1Spec,
    MetropolisC2Spec,
    MetropolisSpec,
    PrefixSumSpec,
    RejectionSpec,
)
from repro_torch.kernels import common as tc
from repro_torch.kernels.megopolis import megopolis as mk
from repro_torch.kernels.metropolis import metropolis as tk

N, B, S, D = 2048, 8, 3, 2
DTYPES = ("bfloat16", "float16")
FAMILIES = {"megopolis": (JaxMegopolisSpec, {"segment": 1024}),
            "metropolis": (JaxMetropolisSpec, {})}
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


def _edge_values() -> np.ndarray:
    """Normal values, float32 subnormals, values below float16's smallest
    normal (6.1e-5) and subnormal (6e-8), past float16's largest, signed
    zeros, infinities and NaN."""
    rng = np.random.default_rng(0)
    return np.concatenate([
        rng.normal(size=64) * 3, [1e-39, -1e-39, 1e-45, 3e-5, -7e-6, 5e-8, 2e-8, 1.0000001],
        [7e4, -7e4, 65519.0, 65520.0, 3.3e38, 0.0, -0.0, np.inf, -np.inf, np.nan],
    ]).astype(np.float32)


def _same_bits(got: np.ndarray, want: np.ndarray):
    """Bit for bit, but for a NaN's sign and payload (torch and XLA narrow
    a NaN to different ones; every NaN is a NaN to the kernels)."""
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(_bits(got[~nan]), _bits(want[~nan]))


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantise_and_compress_match_jax(dtype):
    x = _edge_values()
    got_q = tc.quantise_plane(torch.from_numpy(x), dtype)
    got_c = tc.compress_plane(torch.from_numpy(x), dtype)
    assert got_q.dtype == torch.float32 and got_c.dtype == getattr(torch, dtype)
    _same_bits(got_q.numpy(), np.asarray(jc.quantise_plane(jnp.asarray(x), dtype)))
    want_c = np.asarray(jc.compress_plane(jnp.asarray(x), dtype).astype(jnp.float32))
    _same_bits(got_c.to(torch.float32).numpy(), want_c)
    # Idempotent: narrowing a quantised plane loses nothing.
    _same_bits(tc.compress_plane(got_q, dtype).to(torch.float32).numpy(),
               got_c.to(torch.float32).numpy())
    assert tc.plane_itemsize(dtype) == jc.plane_itemsize(dtype) == 2


@pytest.mark.parametrize("dtype", DTYPES + ("float32",))
def test_int_planes_pass_through(dtype):
    x = torch.arange(-5, 5, dtype=torch.int32)
    assert tc.quantise_plane(x, dtype) is x and tc.compress_plane(x, dtype) is x
    assert tc.state_itemsize(x, dtype) == 4
    assert tc.state_itemsize(x.float(), dtype) == jc.state_itemsize(jnp.zeros(2), dtype)


def test_canonical_plane_dtype():
    assert tc.canonical_plane_dtype(None) is torch.float32
    assert tc.canonical_plane_dtype(torch.bfloat16) is torch.bfloat16
    assert tc.canonical_plane_dtype("float16") is torch.float16
    with pytest.raises(ValueError, match="plane_dtype"):
        tc.canonical_plane_dtype("float64")


@pytest.mark.parametrize("cls", (MegopolisSpec, MetropolisSpec))
@pytest.mark.parametrize("dtype", DTYPES)
def test_compressed_families_build(cls, dtype):
    r = cls(num_iters=4, plane_dtype=dtype).build()
    assert r.plane_dtype == dtype
    x = torch.randn(8)
    assert torch.equal(r.quantise(x), tc.quantise_plane(x, dtype))


@pytest.mark.parametrize("make", (
    lambda pd: MetropolisC1Spec(plane_dtype=pd), lambda pd: MetropolisC2Spec(plane_dtype=pd),
    lambda pd: RejectionSpec(plane_dtype=pd), lambda pd: PrefixSumSpec(plane_dtype=pd),
))
@pytest.mark.parametrize("dtype", DTYPES)
def test_other_families_name_item_2(make, dtype):
    """C1, C2, rejection and the prefix-sum family take both 2-byte dtypes
    (ROADMAP Queue A item 2 is done) and refuse float64."""
    r = make(dtype).build()
    assert r.plane_dtype == dtype
    x = torch.randn(8)
    assert torch.equal(r.quantise(x), tc.quantise_plane(x, dtype))
    with pytest.raises(ValueError, match="plane_dtype"):
        make("float64")


# ------------------------------------------------------------ against JAX
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
    cls, extra = FAMILIES[family]
    jr = cls(num_iters=B, backend="pallas_interpret", plane_dtype=dtype, **extra).build()
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
    """``r_bf16(key, w) == r_f32(key, r_bf16.quantise(w))``, index only and
    fused (the particles too, in the caller's dtype)."""
    cls = MegopolisSpec if family == "megopolis" else MetropolisSpec
    r16, r32 = cls(num_iters=B, plane_dtype=dtype).build(), cls(num_iters=B).build()
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


# ------------------------------------------------------- wrappers and checks
@pytest.mark.parametrize("dtype", DTYPES)
def test_wrappers_take_planes_on_cpu(dtype):
    """The plain versions take 2-byte planes and count no launch; the
    kernels' census names follow the word."""
    dt = getattr(torch, dtype)
    w = torch.rand(2, N).to(dt)
    state = torch.randn(2, D, N).to(dt)
    offsets = torch.randint(0, N, (2, B), dtype=torch.int32)
    seeds = torch.tensor([3, 4])
    mk.reset_launch_counts()
    anc, out = mk.megopolis_fused_rows(w, state, offsets, seeds)
    anc2, out2 = tk.metropolis_fused_batch(w, state, seeds, B)
    assert out.dtype == out2.dtype == dt and anc.dtype == anc2.dtype == torch.int32
    assert torch.equal(out, torch.gather(state, 2, anc.long()[:, None].expand_as(state)))
    assert mk.megopolis_fused_rows.launches == 0
    word = tc.PLANE_WORDS[dt]
    assert tc.plane_instance("megopolis_fused_rows_kernel", True, state=1)(w, state) == \
        f"megopolis_fused_rows_kernel<true, {word}, unsigned short>"
    assert tc.plane_instance("metropolis_step_rows_kernel", state=1)(w, state) == \
        f"metropolis_step_rows_kernel<{word}, unsigned short>"


def test_other_kernels_refuse_planes():
    """The rejection wrapper takes 2-byte weights (its plain version on the
    CPU, the values of the float32 call on the quantised weights) and
    refuses a dtype that is no plane dtype."""
    from repro_torch.kernels.rejection import rejection as rk

    w = torch.rand(N)
    for dt in (torch.bfloat16, torch.float16):
        got = rk.rejection(w.to(dt), torch.tensor(1), 8)
        assert got.dtype == torch.int32
        assert torch.equal(got, rk.rejection(w.to(dt).float(), torch.tensor(1), 8))
    with pytest.raises(ValueError, match="bfloat16"):
        rk.rejection(w.to(torch.float64), torch.tensor(1), 8)


@pytest.mark.parametrize("dtype", DTYPES)
def test_contract_cells_launch_their_f32_budget(dtype):
    cells = list(audit_matrix(families=("megopolis", "metropolis", "rejection"),
                              device="cpu", plane_dtypes=("float32", dtype),
                              backends=("cuda",)))
    compressed = [c for c in cells if c.cell.endswith(f"@{dtype}")]
    assert len(compressed) == 24  # every family has its compressed cells
    budgets = {c.cell: c.launches for c in cells}
    for c in compressed:
        assert c.ok, c.violations
        assert c.launches == c.max_launches == budgets[c.cell.split("@")[0]] == 1
