"""The port's shared kernel primitives (``repro_torch.kernels.common``)
against ``repro.kernels.common``.

The hash RNG and ``key_to_seed`` are integer arithmetic and must match bit
for bit.  ``step_stats`` sums in torch's order, not XLA's: ``ess_norm`` and
``max_weight`` are ratios of sums of at most 8192 positive terms, each sum
within a few float32 ULP of the exact value in either order, so they agree
to ``STATS_RTOL``; ``incr = m + log(Σw) - log(N)`` to ``INCR_ATOL``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.resamplers.megopolis import megopolis_indices as jax_megopolis_indices
from repro.kernels import common as jc
from repro_torch.convert import key_from_jax
from repro_torch.core.resamplers.megopolis import megopolis_indices
from repro_torch.kernels import common as tc

STATS_RTOL = 2e-6
INCR_ATOL = 2e-6


def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def test_murmur3_fmix_bits():
    x = np.random.default_rng(0).integers(0, 2**32, 10_000, dtype=np.uint64).astype(np.uint32)
    want = _u32(jc.murmur3_fmix(jnp.asarray(x)))
    np.testing.assert_array_equal(tc.murmur3_fmix(torch.from_numpy(x.astype(np.int64))).numpy(),
                                  want)


@pytest.mark.parametrize("seed", (0, 1, 0x9E3779B9, 2**32 - 1))
@pytest.mark.parametrize("iteration", (0, 1, 31, 4095))
def test_hash_bits_and_uniform(seed, iteration):
    lanes = np.arange(8192, dtype=np.int32)
    want = _u32(jc.hash_bits(jnp.uint32(seed), jnp.asarray(lanes), iteration))
    got = tc.hash_bits(seed, torch.from_numpy(lanes).to(torch.int64), iteration)
    np.testing.assert_array_equal(got.numpy(), want)
    want_u = np.asarray(jc.hash_uniform(jnp.uint32(seed), jnp.asarray(lanes), iteration))
    got_u = tc.hash_uniform(seed, torch.from_numpy(lanes).to(torch.int64), iteration).numpy()
    np.testing.assert_array_equal(got_u.view(np.int32), want_u.view(np.int32))


@pytest.mark.parametrize("seed", (0, 7, 2**31 - 1))
def test_key_to_seed_bits(seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), 16)
    want = _u32(jc.key_to_seed(keys))
    np.testing.assert_array_equal(
        tc.key_to_seed(key_from_jax(jax.random.key_data(keys))).numpy(), want)


def test_seed_bits_reinterpret_uint32():
    seeds = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1])
    np.testing.assert_array_equal(tc.seed_bits(seeds).numpy().view(np.uint32),
                                  seeds.numpy().astype(np.uint32))


@pytest.mark.parametrize("n", (4096, 8192))
def test_comparison_ids_match_megopolis_indices(n):
    i = np.arange(n, dtype=np.int32)
    for o in (0, 1, 1023, 1024, 1500, n - 1):
        want = np.asarray(jax_megopolis_indices(jnp.asarray(i), jnp.int32(o), 1024, n))
        got = tc.megopolis_indices(torch.from_numpy(i), o, tc.SEG, n).numpy()
        np.testing.assert_array_equal(got, want)
        assert sorted(got.tolist()) == list(range(n))  # a bijection
    np.testing.assert_array_equal(megopolis_indices(torch.arange(64), 5, 32, 64).numpy(),
                                  np.asarray(jax_megopolis_indices(jnp.arange(64), 5, 32, 64)))


def test_flush_to_zero():
    x = torch.tensor([1e-39, -1e-39, 1.2e-38, 0.0, -0.0, 1.0, float("inf"), float("nan")])
    got = tc.flush_to_zero(x)
    assert got[:2].eq(0).all() and torch.signbit(got[1]) and not torch.signbit(got[0])
    torch.testing.assert_close(got[2:], x[2:], equal_nan=True, rtol=0, atol=0)


def test_quantise_plane_identity_at_f32():
    x = torch.randn(16)
    assert tc.quantise_plane(x, "float32") is x
    q = tc.quantise_plane(x, "bfloat16")
    assert q.dtype == torch.float32 and torch.equal(q, x.to(torch.bfloat16).float())
    with pytest.raises(ValueError, match="plane_dtype"):
        tc.quantise_plane(x, "float64")


def _banks():
    rng = np.random.default_rng(1)
    banks = {
        "normal3": (rng.normal(size=(3, 4096)) * 3).astype(np.float32),
        "wide": (rng.normal(size=(2, 8192)) * 40).astype(np.float32),
        "one_hot": np.where(np.arange(4096) == 17, 0.0, -np.inf)[None].astype(np.float32),
        "all_neg_inf": np.full((1, 4096), -np.inf, np.float32),
        "has_nan": np.where(np.arange(4096) == 5, np.nan, 0.0)[None].astype(np.float32),
        "subnormal_tail": np.concatenate(
            [np.zeros(8), np.full(4088, -88.0)]).astype(np.float32)[None],
    }
    return banks


@pytest.mark.parametrize("name", list(_banks()))
def test_step_stats_match(name):
    lw = _banks()[name]
    n = lw.shape[-1]
    m, ess, incr, maxw, deg = tc.step_stats(torch.from_numpy(lw))
    for s in range(lw.shape[0]):
        jm, jess, jincr, jmaxw, jdeg = (np.asarray(v) for v in
                                        jax.jit(jc.step_stats, static_argnums=1)(lw[s], n))
        assert bool(deg[s]) == bool(jdeg)
        np.testing.assert_array_equal(m[s].numpy(), jm)  # a max is exact in any order
        np.testing.assert_allclose(ess[s].numpy(), jess, rtol=STATS_RTOL)
        np.testing.assert_allclose(maxw[s].numpy(), jmaxw, rtol=STATS_RTOL)
        np.testing.assert_allclose(incr[s].numpy(), jincr, atol=INCR_ATOL, equal_nan=True)


def test_step_select():
    k = torch.tensor([[3, 3, 0, 1], [2, 2, 2, 2]])
    got = tc.step_select(torch.tensor([True, False]), k)
    np.testing.assert_array_equal(got.numpy(), [[3, 3, 0, 1], [0, 1, 2, 3]])


def test_build_target_hashes_included_headers(tmp_path, monkeypatch):
    """An edit to a header a CUDA source includes renames the source's
    library, so it is rebuilt; an edit elsewhere does not."""
    import shutil

    from repro_torch.kernels import build

    kernels = tmp_path / "kernels"
    shutil.copytree(build.KERNELS_DIR, kernels, ignore=shutil.ignore_patterns("_build"))
    monkeypatch.setattr(build, "KERNELS_DIR", kernels)
    monkeypatch.setattr(build, "BUILD_DIR", kernels / "_build")
    assert build.sources() == ["fixtures/csrc/fixtures.cu", "megopolis/csrc/megopolis.cu",
                               "metropolis/csrc/c1c2.cu",
                               "metropolis/csrc/metropolis.cu", "prefix_sum/csrc/prefix_sum.cu",
                               "reduce/csrc/reduce.cu", "rejection/csrc/rejection.cu"]
    before = {src: build._target(src) for src in build.sources()}
    (kernels / "common.py").write_text("# not included by any source\n")
    assert {src: build._target(src) for src in build.sources()} == before
    header = kernels / "common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {src: build._target(src) for src in build.sources()}
    assert all(after[src] != before[src] for src in before)


@pytest.mark.parametrize("bad", ("rows", "s_times_n", "n", "seeds", "state"))
def test_check_bank_rejects(bad):
    n = {"s_times_n": 1 << 30, "n": 3000}.get(bad, 4096)
    s = {"rows": tc.MAX_ROWS + 1, "s_times_n": 2}.get(bad, 2)
    w = torch.zeros(1, 1).expand(s, n)  # shapes only: nothing the size of the bank
    state = torch.empty(s, 1, n + 1024) if bad == "state" else None
    seeds = torch.zeros(s + (bad == "seeds"), dtype=torch.int64)
    with pytest.raises(ValueError):
        tc.check_bank("who", w, state, seeds)
    assert tc.check_bank("who", torch.empty(2, 4096), torch.empty(2, 3, 4096),
                         torch.zeros(2, dtype=torch.int64)) == (2, 4096, 3)


@pytest.mark.parametrize("offset", (0, 1, 2, 3, 4))
def test_check_aligned(offset):
    """``check_aligned``, which the Megopolis and C1/C2 index-only and fused
    wrappers run on CUDA weights before a launch (their bulk copies need a
    16-byte boundary): a view ``offset`` floats into an aligned buffer
    passes at 0 and 4 and is refused, with no copy, at 1-3."""
    base = torch.zeros(4 + 2 * 4096)
    assert base.data_ptr() % 16 == 0
    w = base[offset:offset + 2 * 4096].view(2, 4096)
    if offset % 4 == 0:
        tc.check_aligned("metropolis_c2_batch", w)
    else:
        with pytest.raises(ValueError, match="16-byte boundary"):
            tc.check_aligned("metropolis_c2_batch", w)


def test_planes_round_trip():
    p = torch.randn(2, 4096, 3)
    planes = tc.to_planes(p, 2)
    assert planes.shape == (2, 3, 4096) and torch.equal(planes[1, 2], p[1, :, 2])
    assert torch.equal(tc.from_planes(planes, p), p)
    q = torch.randn(4096)
    assert tc.to_planes(q, 1).shape == (1, 4096)
    assert torch.equal(tc.from_planes(tc.to_planes(q, 1), q), q)


def test_first_threaded_exp_after_the_port_set_up_is_exact():
    """Importing the port sets MKL's VML up on one thread, so a process's
    first threaded ``exp`` (4096 elements, two OpenMP chunks) equals a later
    one bit for bit while XLA runs beside it (``_torch_vml_first_call.py``'s
    ``setup`` arm; its ``cold`` arm shows the unset-up race, which is
    MKL's)."""
    script = Path(__file__).with_name("_torch_vml_first_call.py")
    env = dict(os.environ, PYTHONPATH=str(script.parent.parent / "src"))
    out = subprocess.run([sys.executable, str(script), "--runs", "1", "--jobs", "2"],
                         capture_output=True, text=True, env=env, timeout=600, check=True)
    arms = {r["arm"]: r for r in map(json.loads, out.stdout.strip().splitlines())}
    assert arms["setup"]["processes"] == 1 and arms["setup"]["first_call_differed"] == 0
