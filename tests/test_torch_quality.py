"""The port's resampling-quality study (paper §5, Fig. 6) against the JAX
package: the weight generator, the offspring metrics, the closed-form
iteration count, and the offspring matrix of K Monte Carlo resamples.

* ``offspring_counts`` is integer counting: bit for bit.
* ``mse`` and ``bias_variance`` over one offspring matrix: float32 sums in
  torch's order, not XLA's; each is a sum of at most N·K squares of
  numbers below 1e3, so they agree to ``METRIC_RTOL``.
* ``gaussian_weights``: its draw ``x`` is within 3 ULP of
  ``jax.random.normal`` (``test_torch_random.py``); ``exp(-(x - y)^2 / 2)``
  turns an error of ``d`` in ``x`` into a relative error of ``|x - y|·d``,
  so the weights are held to ``3·max|x|·max|x - y| + 2`` ULP.
* The offspring matrix of ``batch_rows`` over ``split(key, K)`` equals the
  JAX benchmarks' ``offsprings_for`` (``benchmarks/common.py``: a
  ``lax.map`` of the single call over ``split(key, K)``, repeated here)
  bit for bit, for both families, on JAX's weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as jmet
from repro.core.iterations import gaussian_weight_iterations as jax_iters
from repro.core.spec import MegopolisSpec as JaxMegopolisSpec
from repro.core.spec import MetropolisSpec as JaxMetropolisSpec
from repro.core.weightgen import GAMMA_ALPHA_GRID as JAX_GAMMA_GRID
from repro.core.weightgen import GAUSSIAN_Y_GRID as JAX_Y_GRID
from repro.core.weightgen import gaussian_weights as jax_gaussian_weights
from repro_torch import convert
from repro_torch import random as trandom
from repro_torch.core import metrics as tmet
from repro_torch.core.iterations import gaussian_weight_iterations
from repro_torch.core.spec import MegopolisSpec, MetropolisSpec
from repro_torch.core.weightgen import (
    GAMMA_ALPHA_GRID,
    GAUSSIAN_Y_GRID,
    gamma_weights,
    gaussian_weights,
)

METRIC_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _partitionable():
    assert jax.config.jax_threefry_partitionable


def _tkey(key):
    return convert.key_from_jax(jax.random.key_data(key))


def offsprings_for(resampler_fn, key, weights, runs: int):
    """``benchmarks/common.py:offsprings_for``: int32[runs, N] offspring
    matrix over ``runs`` Monte Carlo resamples."""
    n = weights.shape[0]
    one = jax.jit(lambda k: jnp.bincount(resampler_fn(k, weights), length=n))
    return jax.lax.map(one, jax.random.split(key, runs))


def _offsprings(seed=0, k=5, n=4096):
    rng = np.random.default_rng(seed)
    w = rng.gamma(0.5, size=n).astype(np.float32)
    anc = np.stack([rng.choice(n, size=n, p=w / w.sum()) for _ in range(k)]).astype(np.int32)
    return w, anc


def test_offspring_counts_bits():
    w, anc = _offsprings()
    want = np.stack([np.asarray(jmet.offspring_counts(jnp.asarray(a), 4096)) for a in anc])
    got = tmet.offspring_counts(torch.from_numpy(anc), 4096)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tmet.offspring_counts(torch.from_numpy(anc[0]), 4096).numpy(),
                                  want[0])
    assert int(got.sum()) == anc.size


@pytest.mark.parametrize("k", (1, 5))
def test_bias_variance_and_mse(k):
    w, anc = _offsprings(seed=k, k=k)
    off = np.stack([np.asarray(jmet.offspring_counts(jnp.asarray(a), w.shape[0])) for a in anc])
    jvar, jbias, jtotal = (float(v) for v in jmet.bias_variance(jnp.asarray(off), jnp.asarray(w)))
    tvar, tbias, ttotal = (float(v) for v in tmet.bias_variance(torch.from_numpy(off),
                                                                  torch.from_numpy(w)))
    if k == 1:
        assert tvar == jvar == 0.0  # one run carries no variance information
    np.testing.assert_allclose([tvar, tbias, ttotal], [jvar, jbias, jtotal], rtol=METRIC_RTOL)
    np.testing.assert_allclose(float(tmet.mse(torch.from_numpy(off), torch.from_numpy(w))),
                               float(jmet.mse(jnp.asarray(off), jnp.asarray(w))),
                               rtol=METRIC_RTOL)
    np.testing.assert_allclose(
        float(tmet.bias_contribution(torch.from_numpy(off), torch.from_numpy(w))),
        float(jmet.bias_contribution(jnp.asarray(off), jnp.asarray(w))), rtol=METRIC_RTOL)
    np.testing.assert_allclose(
        float(tmet.squared_error(torch.from_numpy(off[0]), torch.from_numpy(w))),
        float(jmet.squared_error(jnp.asarray(off[0]), jnp.asarray(w))), rtol=METRIC_RTOL)


@pytest.mark.parametrize("y", (0.0, 2.0, 4.0))
def test_gaussian_weights_within_ulp_bound(y):
    n = 8192
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_gaussian_weights(key, n, y))
    got = gaussian_weights(_tkey(key), n, y, device="cpu").numpy()
    x = np.asarray(jax.random.normal(key, (n,)))
    bound = 3 * np.abs(x).max() * np.abs(x - y).max() + 2
    ulp = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert got.dtype == np.float32 and got.shape == (n,)
    assert ulp.max() <= bound, (ulp.max(), bound)


def test_grids_and_iterations():
    assert GAUSSIAN_Y_GRID == JAX_Y_GRID and GAMMA_ALPHA_GRID == JAX_GAMMA_GRID
    for y in GAUSSIAN_Y_GRID:
        assert gaussian_weight_iterations(y, 0.01) == jax_iters(y, 0.01)
    assert [gaussian_weight_iterations(y, 0.01) for y in (0.0, 2.0, 4.0)] == [4, 16, 354]


def test_gamma_weights_not_ported():
    """Once a raise of the unported sampler; now Method 2's weights run on the
    CPU: positive, finite, of the asked shape (the twin's bounds against
    ``jax.random.gamma`` are ``tests/test_torch_gamma.py``'s)."""
    w = gamma_weights(trandom.PRNGKey(0), 4096, 0.5, device="cpu")
    assert w.dtype == torch.float32 and w.shape == (4096,)
    assert bool(torch.isfinite(w).all()) and bool((w >= 0).all())


def test_weight_generators_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gaussian_weights(trandom.PRNGKey(0), 4096, 2.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gamma_weights(trandom.PRNGKey(0), 4096, 0.5)


@pytest.mark.parametrize("family", ("megopolis", "metropolis"))
def test_offspring_matrix_matches_offsprings_for(family):
    """Fig. 6's K Monte Carlo resamples: the port's one ``batch_rows``
    launch over ``split(key, K)`` against the JAX benchmark's
    ``offsprings_for``; then the quality metrics of both."""
    n, k, y = 4096, 6, 2.0
    b = gaussian_weight_iterations(y, 0.01)
    if family == "megopolis":
        jr = JaxMegopolisSpec(num_iters=b, segment=1024, backend="pallas_interpret").build()
        tr = MegopolisSpec(num_iters=b).build()
    else:
        jr = JaxMetropolisSpec(num_iters=b, backend="pallas_interpret").build()
        tr = MetropolisSpec(num_iters=b).build()
    kw = jax.random.fold_in(jax.random.PRNGKey(17), int(y * 100))
    w = jax_gaussian_weights(kw, n, y)
    key = jax.random.fold_in(kw, 1)
    want = np.asarray(offsprings_for(jr, key, w, k))
    tw = torch.from_numpy(np.array(w))
    anc = tr.batch_rows(trandom.split(_tkey(key), k), tw[None].expand(k, n).contiguous())
    got = tmet.offspring_counts(anc, n)
    np.testing.assert_array_equal(got.numpy(), want)
    jvar, jbias, jtotal = (float(v) for v in jmet.bias_variance(jnp.asarray(want), w))
    tvar, tbias, ttotal = (float(v) for v in tmet.bias_variance(got, tw))
    np.testing.assert_allclose([tvar, tbias, ttotal], [jvar, jbias, jtotal], rtol=METRIC_RTOL)
