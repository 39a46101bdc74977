"""Residual resampling's normaliser on the reference backend (ROADMAP Queue C
item 22) against the JAX package, on the CPU.

``xla_sum`` adds in XLA-CPU's order for ``jnp.sum``: windows of 32 over
zero padding split half in front and half behind
(``TreeReductionRewriter``'s reduce-window: ``pad=15_16`` at N = 33,
``12_12`` at 1000), repeated while more than 32 values remain.  It equals
``jnp.sum`` bit for bit at every length tested, so residual's reference
ancestors equal the JAX package's ``backend="reference"`` ones, also at
the lengths where the former order (all the padding behind) was a few ULP
off: 33, 100, 1000, 10000.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.spec import spec_for_backend as jax_spec_for_backend
from repro_torch.convert import key_from_jax
from repro_torch.core.resamplers import prefix_sum as tprefix
from repro_torch.core.spec import spec_for_backend

#: Lengths of ``jnp.sum``'s tree: below, at and past one window, two levels
#: and three, and the sizes where the padding behind did not match.
SUM_LENGTHS = (1, 2, 31, 32, 33, 64, 65, 100, 999, 1000, 1023, 1025, 4097, 10000, 33000,
               100001, (1 << 20) + 3)


@pytest.fixture(autouse=True)
def _partitionable():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("n", SUM_LENGTHS)
def test_xla_sum_is_jnp_sum(n):
    rng = np.random.default_rng(n)
    for scale in (1e-3, 1.0, 1e3):
        x = (rng.gamma(0.5, size=n) * scale).astype(np.float32)
        want = np.asarray(jnp.sum(jnp.asarray(x)))
        got = tprefix.xla_sum(torch.from_numpy(x)).numpy()
        assert got.view(np.int32) == want.view(np.int32), (n, scale, got, want)


@pytest.mark.parametrize("n", (33, 100, 1000, 10000))
def test_residual_reference_ancestors_are_jaxs(n):
    rng = np.random.default_rng(n + 1)
    w = rng.gamma(0.5, size=n).astype(np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = jax_spec_for_backend("residual", "reference").build()(key, jnp.asarray(w))
        got = spec_for_backend("residual", "reference").build()(
            key_from_jax(jax.random.key_data(key)), torch.from_numpy(w))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
