"""The gamma sampler (``repro_torch.random.gamma``, ``core.weightgen.
gamma_weights``: Fig. 6's Method 2, paper eq. (13)) against
``jax.random.gamma`` on the CPU.

The twin follows jax 0.9.0's ``_gamma_impl`` lane for lane: one key per
element, Marsaglia-Tsang's loop with its own key chain, alpha < 1 boosted.
It calls ``normal`` (within 3 ULP of JAX's, ``tests/test_torch_random.py``),
``log`` and ``pow``, which may round differently from XLA's, so it is held
two ways per alpha of ``GAMMA_ALPHA_GRID``, over 2 x 2^14 lanes (keys 0 and
1):

* the share of lanes bit for bit with JAX (``BIT_EQUAL_SHARE``) and the
  largest ULP gap among the rest (``ULP_BOUND``), measured (the last column)
  and held with a margin: 0.5: 84.5%, 67 ULP; 2: 88.0%, 22; 3: 84.5%, 14;
  10: 94.5%, 7; 50: 97.5%, 8.  A 1-ULP difference in ``log`` at the accept
  boundary would flip a lane's decision and draw another sample; none was
  seen in these lanes (nor in 2^14 more at key 2).
* distributionally: a Kolmogorov-Smirnov test against ``scipy.stats.gamma``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from repro.core.weightgen import GAMMA_ALPHA_GRID as JAX_GAMMA_GRID
from repro.core.weightgen import gamma_weights as jax_gamma_weights
from repro_torch import random as trandom
from repro_torch.core.weightgen import GAMMA_ALPHA_GRID, gamma_weights

LANES = 1 << 14
KEYS = (0, 1)
#: alpha -> (least share of lanes bit for bit, largest ULP gap of the rest).
BIT_EQUAL_SHARE = {0.5: 0.80, 2.0: 0.84, 3.0: 0.80, 10.0: 0.92, 50.0: 0.95}
ULP_BOUND = {0.5: 256, 2.0: 64, 3.0: 64, 10.0: 16, 50.0: 16}
KS_P_FLOOR = 1e-3


@pytest.fixture(autouse=True)
def _partitionable():
    assert jax.config.jax_threefry_partitionable


def _ulp(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("alpha", GAMMA_ALPHA_GRID)
def test_gamma_matches_jax_within_stated_bounds(alpha):
    assert GAMMA_ALPHA_GRID == JAX_GAMMA_GRID
    shares, gaps = [], []
    for seed in KEYS:
        got = gamma_weights(trandom.PRNGKey(seed), LANES, alpha, device="cpu").numpy()
        want = np.asarray(jax_gamma_weights(jax.random.PRNGKey(seed), LANES, alpha))
        assert got.dtype == np.float32 and got.shape == (LANES,)
        assert (got > 0).all() and np.isfinite(got).all()
        ulp = _ulp(got, want)
        shares.append(float((ulp == 0).mean()))
        gaps.append(int(ulp.max()))
    print(f"alpha {alpha}: bit-equal share {shares}, largest ULP gap {gaps}")
    assert min(shares) >= BIT_EQUAL_SHARE[alpha]
    assert max(gaps) <= ULP_BOUND[alpha]


@pytest.mark.parametrize("alpha", GAMMA_ALPHA_GRID)
def test_gamma_distribution_ks(alpha):
    got = gamma_weights(trandom.PRNGKey(2), LANES, alpha, device="cpu").numpy()
    p = scipy.stats.kstest(got.astype(np.float64), scipy.stats.gamma(alpha).cdf).pvalue
    assert p > KS_P_FLOOR, p


def test_gamma_weights_scale_and_shape():
    key = trandom.PRNGKey(3)
    g = trandom.gamma(key, 2.0, (4, 8))
    assert g.shape == (4, 8) and g.dtype == torch.float32
    np.testing.assert_array_equal(
        gamma_weights(key, 32, 2.0, beta=2.0, device="cpu").numpy(),
        (g.reshape(-1) / 2.0).numpy())
    want = np.asarray(jax_gamma_weights(jax.random.PRNGKey(3), 32, 2.0, beta=2.0))
    assert _ulp(gamma_weights(key, 32, 2.0, beta=2.0, device="cpu").numpy(), want).max() <= 64
    with pytest.raises(ValueError):
        trandom.gamma(key, 0.0, (4,))


def test_gamma_one_lane_per_key():
    """Element i draws from ``split(key, n)[i]``: one lane's sample does not
    depend on the others' rejection loops."""
    key = trandom.PRNGKey(4)
    full = trandom.gamma(key, 0.5, (64,))
    lanes = trandom.split(key, 64)
    alone = trandom._gamma_lanes(lanes[10:11], 0.5, torch.device("cpu"))
    assert torch.equal(full[10:11], alone)
    assert jnp.asarray(full.numpy()).shape == (64,)
