"""The port's fault injectors (``repro_torch.resilience.faults``) against the
JAX package's on the same key data, and the chaos matrix on the CPU.

* Each injector (``inject_nan_weights``, ``inject_inf_weights``,
  ``bitflip_states``, ``poison_ancestors``) and each ``FAULT_CLASSES``
  generator gives the JAX package's plane bit for bit.
* The chaos matrix: a bank of clean rows and faulty ones (every
  ``FAULT_CLASSES`` bank, NaN and inf weights at rate 0.1) through every
  Path A family's ``step_rows`` at ``guard="recover"``, on the ``cuda``
  backend (the kernels' plain versions here) and on ``reference``: the
  clean rows equal ``guard="off"`` bit for bit, every output is finite and
  every ancestor vector passes ``validate_ancestors``; ``poison_ancestors``
  makes it raise ``CorruptAncestorsError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.resilience import faults as jfaults
from repro_torch import random as trandom
from repro_torch.convert import key_from_jax
from repro_torch.core.spec import spec_for_backend
from repro_torch.resilience import faults
from repro_torch.resilience.errors import CorruptAncestorsError

N, D, B, MAX_ITERS = 1024, 2, 8, 24
RATE = 0.1
#: Path A's families (``chip_smoke.py``).
FAMILIES = ("megopolis", "metropolis", "metropolis_c1", "metropolis_c2", "rejection",
            "multinomial", "improved_systematic", "residual")
#: The rows of the chaos bank: clean ones, then each fault.
ROWS = ("clean", *faults.FAULT_CLASSES, "nan_weights", "inf_weights", "clean")


@pytest.fixture(autouse=True)
def _partitionable():
    assert jax.config.jax_threefry_partitionable


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("seed", (0, 7))
def test_injectors_are_jaxs(seed):
    key = jax.random.PRNGKey(seed)
    tkey = key_from_jax(jax.random.key_data(key))
    w = np.random.default_rng(seed).random((3, 1000)).astype(np.float32)
    for name in ("inject_nan_weights", "inject_inf_weights"):
        want = getattr(jfaults, name)(key, jnp.asarray(w), RATE)
        got = getattr(faults, name)(tkey, torch.from_numpy(w), RATE)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    want = jfaults.inject_inf_weights(key, jnp.asarray(w), RATE, sign=-1)
    got = faults.inject_inf_weights(tkey, torch.from_numpy(w), RATE, sign=-1)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    want = jfaults.bitflip_states(key, jnp.asarray(w), 0.05)
    got = faults.bitflip_states(tkey, torch.from_numpy(w), 0.05)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert (_bits(got.numpy()) != _bits(w)).sum() > 0
    anc = np.arange(2000, dtype=np.int32) % 1000
    want = jfaults.poison_ancestors(key, jnp.asarray(anc), 1000, 0.05)
    got = faults.poison_ancestors(tkey, torch.from_numpy(anc), 1000, 0.05)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bernoulli_is_jaxs():
    key = jax.random.PRNGKey(4)
    for p in (0.0, 0.1, 0.5, 1.0):
        want = jax.random.bernoulli(key, p, (5000,))
        got = trandom.bernoulli(key_from_jax(jax.random.key_data(key)), p, (5000,))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", tuple(faults.FAULT_CLASSES))
def test_fault_classes_are_jaxs(name):
    want = jfaults.FAULT_CLASSES[name](257)
    got = faults.FAULT_CLASSES[name](257, device="cpu")
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_validate_ancestors_catches_poison():
    anc = torch.arange(N, dtype=torch.int32)
    assert faults.validate_ancestors(anc, N) is anc
    bad = faults.poison_ancestors(trandom.PRNGKey(1), anc, N, 0.05)
    with pytest.raises(CorruptAncestorsError, match="out-of-range"):
        faults.validate_ancestors(bad, N)


def _chaos_bank():
    """Log-weights ``[len(ROWS), N]``: clean rows of N(0, 3²) values, then
    the faults; and the particles ``[len(ROWS), N, D]``."""
    rng = np.random.default_rng(3)
    clean = torch.from_numpy((3.0 * rng.standard_normal((len(ROWS), N))).astype(np.float32))
    key = trandom.PRNGKey(9)
    rows = []
    for i, row in enumerate(ROWS):
        if row in faults.FAULT_CLASSES:
            rows.append(faults.FAULT_CLASSES[row](N, device="cpu"))
        elif row == "nan_weights":
            rows.append(faults.inject_nan_weights(trandom.fold_in(key, i), clean[i], RATE))
        elif row == "inf_weights":
            rows.append(faults.inject_inf_weights(trandom.fold_in(key, i), clean[i], RATE))
        else:
            rows.append(clean[i])
    particles = torch.from_numpy(rng.standard_normal((len(ROWS), N, D)).astype(np.float32))
    return torch.stack(rows), particles


@pytest.mark.parametrize("backend", ("cuda", "reference"))
@pytest.mark.parametrize("family", FAMILIES)
def test_chaos_matrix(family, backend):
    lw, particles = _chaos_bank()
    keys = trandom.split(trandom.PRNGKey(5), len(ROWS))
    out = {}
    for guard in ("off", "recover"):
        r = spec_for_backend(family, backend, num_iters=B, max_iters=MAX_ITERS,
                             guard=guard).build()
        out[guard] = r.step_rows(keys, lw, particles, 0.5)
    p_rec, a_rec, stats = out["recover"]
    p_off, a_off, _ = out["off"]
    clean = [i for i, row in enumerate(ROWS) if row == "clean"]
    assert torch.equal(a_rec[clean], a_off[clean])
    assert torch.equal(p_rec[clean].view(torch.int32), p_off[clean].view(torch.int32))
    faults.validate_ancestors(a_rec, N)
    assert torch.isfinite(p_rec).all()
    degenerate = [ROWS.index(r) for r in ("all_nan", "all_neg_inf", "nan_weights", "inf_weights")]
    assert stats.degenerate[degenerate].all() and not stats.degenerate[clean].any()
    with pytest.raises(CorruptAncestorsError):
        faults.validate_ancestors(faults.poison_ancestors(trandom.PRNGKey(2), a_rec, N, 0.05), N)
