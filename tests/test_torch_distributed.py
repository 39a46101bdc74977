"""The port's distributed Megopolis (``repro_torch.core.distributed``)
against its one-device oracle and the JAX package's, on the CPU.

Four gloo ranks, started by ``torch.multiprocessing.spawn`` over a
``FileStore`` in the test's temporary directory (loopback only), each
resample their block of N = 4 x 2048 weights with B = 24 on the static and
the dynamic schedule.  The ranks' ancestors, put together, equal the port's
``megopolis_hier_ref`` bit for bit, and that equals the JAX package's
``megopolis_hier_ref(n_shards=4)`` on the same key data.
``gather_ancestors`` and ``island_exchange`` move the right values, and the
global ESS agrees with the one-device sum to float32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_dist_worker as worker
from repro.core import distributed as jd
from repro_torch import random as trandom
from repro_torch.convert import key_from_jax
from repro_torch.core import distributed as td
from repro_torch.core.spec import MegopolisSpec, MetropolisSpec
from repro_torch.kernels.common import key_to_seed

WORLD, N, B = 4, 4 * 2048, 24
L = N // WORLD
ESS_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _partitionable():
    assert jax.config.jax_threefry_partitionable


@pytest.fixture(scope="module")
def jkey():
    return jax.random.PRNGKey(3)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jkey):
    """Each rank's results, from one spawn of WORLD gloo processes."""
    tmp = tmp_path_factory.mktemp("dist")
    key_data = [int(v) for v in np.asarray(jax.random.key_data(jkey))]
    mp.spawn(worker.run, args=(WORLD, str(tmp / "store"), str(tmp), N, B, key_data),
             nprocs=WORLD, join=True)
    return [torch.load(tmp / f"rank{r}.pt") for r in range(WORLD)]


def _tables(jkey, schedule):
    """The JAX side's and the port's seed, local offsets and rank offsets."""
    k_seed, k_loc, k_shard = jax.random.split(jkey, 3)
    jt = (jd.key_to_seed(k_seed), jax.random.randint(k_loc, (B,), 0, L, jnp.int32),
          jd._static_shard_schedule(0xA5A5, B, WORLD) if schedule == "static"
          else jax.random.randint(k_shard, (B,), 0, WORLD, jnp.int32))
    ts, tl, th = trandom.split(key_from_jax(jax.random.key_data(jkey)), 3)
    tt = (key_to_seed(ts), trandom.randint(tl, (B,), 0, L),
          td._static_shard_schedule(0xA5A5, B, WORLD) if schedule == "static"
          else trandom.randint(th, (B,), 0, WORLD))
    return jt, tt


def test_static_schedule_is_jaxs():
    for seed in (0, 0xA5A5, 0xFFFFFFF0):
        assert td._static_shard_schedule(seed, 40, 4) == jd._static_shard_schedule(seed, 40, 4)


@pytest.mark.parametrize("schedule", ("static", "dynamic"))
def test_hier_ref_is_jaxs(jkey, schedule):
    w, _ = worker.inputs(N)
    (js, jl, jh), (ts, tl, th) = _tables(jkey, schedule)
    want = np.asarray(jd.megopolis_hier_ref(js, jl, jh, jnp.asarray(w.numpy()),
                                            n_shards=WORLD, num_iters=B))
    got = td.megopolis_hier_ref(ts, tl, th, w, n_shards=WORLD, num_iters=B)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != np.arange(N)).mean() > 0.9  # the resample moved nearly every particle


@pytest.mark.parametrize("schedule", ("static", "dynamic"))
def test_ranks_equal_hier_ref(ranks, jkey, schedule):
    w, _ = worker.inputs(N)
    _, (ts, tl, th) = _tables(jkey, schedule)
    want = td.megopolis_hier_ref(ts, tl, th, w, n_shards=WORLD, num_iters=B)
    got = torch.cat([r[schedule] for r in ranks])
    assert torch.equal(got, want)


def test_gather_ancestors_moves_the_global_values(ranks):
    _, x = worker.inputs(N)
    for r in ranks:
        assert torch.equal(r["gathered"], x[r["static"]])


def test_island_exchange_takes_the_previous_rank_head(ranks):
    _, x = worker.inputs(N)
    m = L // 4
    for s, r in enumerate(ranks):
        prev = x[((s - 1) % WORLD) * L:][:m]
        assert torch.equal(r["island"][:m], prev)
        assert torch.equal(r["island"][m:], x[s * L + m:(s + 1) * L])


def test_effective_sample_size_is_global(ranks):
    w, _ = worker.inputs(N)
    want = float(w.double().sum() ** 2 / (w.double() ** 2).sum())
    for r in ranks:
        assert abs(float(r["ess"]) - want) <= ESS_RTOL * want
    assert len({float(r["ess"]) for r in ranks}) == 1


def test_resampler_refuses_what_jax_refuses():
    with pytest.raises(TypeError, match="MegopolisSpec"):
        td.make_distributed_resampler(spec=MetropolisSpec(num_iters=4))
    with pytest.raises(ValueError, match="concrete num_iters"):
        td.make_distributed_resampler(spec=MegopolisSpec(num_iters="auto", backend="reference"))
    with pytest.raises(ValueError, match="backend='reference'"):
        td.make_distributed_resampler(spec=MegopolisSpec(num_iters=4))
    with pytest.raises(ValueError, match="schedule"):
        td.make_distributed_resampler(num_iters=4, schedule="ring")
