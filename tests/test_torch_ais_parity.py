"""The port's AIS sampler (``repro_torch.ais``) against ``repro.ais``, on the
CPU, from the same keys (``convert.key_from_jax``) and the same inputs
(numpy, from a seed).

Bounds, as measured on these inputs:

* targets: ``log_base`` bit for bit with eager JAX for every family, and
  ``log_target`` for the isotropic Gaussian and the banana; the mixture's
  ``logsumexp`` within 4 ULP, the correlated Gaussian's matrix product and
  the logistic posterior (its data within ``normal``'s 3 ULP) within 16 ULP
  (measured: 1, 4, 4); ``sample_base`` within 4 ULP (``normal``'s 3, then
  the product by the base's scale);
* ``geometric_schedule`` bit for bit with eager JAX; under ``jit`` XLA's
  fused ``pow`` rounds otherwise, within 8 ULP (measured: 5);
* ``conditional_ess`` within 64 ULP (torch sums in another order than
  XLA: measured 0 at N = 256, 20 at N = 1024); ``next_temperature`` then
  within 1e-5 of JAX's β (a midpoint comparison near the crossing may flip,
  and where the CESS is flat the two brackets then close up to a few tol
  apart; measured 2.9e-6, tol = 1e-6);
* ``adapt_step_size`` within 2 ULP (``exp``'s 1, then the product);
* the MALA gradient bit for bit with eager ``jax.grad`` on the isotropic
  Gaussian and the banana, within 1e-5 on the mixture (measured 4.5e-6);
* one RWM / MALA call from the same key and particles: the proposals carry
  ``normal``'s 3 ULP, so a particle's accept decision may flip; at most
  1e-3 of the decisions do (measured: none of 8192 x 3), and particles
  whose decision agrees stay within 1e-5 (measured 1.4e-6);
* whole runs on the ``reference`` backend of both packages (JAX's jitted,
  ``backend="xla"``): logZ within 0.05 of JAX's and both inside the
  analytic gate; beside that gate, the same key chain: logZ within 1e-4 of
  JAX's (measured: within 2.4e-6, where a run from another key lands about
  0.03 away at N = 1024), the same number of resamples, and each
  temperature's accept rate within 1e-3, the share of flipped decisions the
  moves allow (measured: equal).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ais as ja
from repro.core.spec import spec_for_backend as jax_spec_for_backend
from repro_torch import ais as ta
from repro_torch import convert
from repro_torch.ais.moves import _value_and_grad
from repro_torch.core.spec import spec_for_backend

CPU = "cpu"
RUN_ATOL = 0.05
#: Whole runs from one key: logZ's gap to JAX's, and each temperature's
#: accept rate's (the flip share of ``test_moves_match_from_the_same_key``).
RUN_LOGZ_TIGHT = 1e-4
RUN_ACCEPT_ATOL = 1e-3
N_RUN = 1024


@pytest.fixture(autouse=True)
def _partitionable():
    assert jax.config.jax_threefry_partitionable


def _tkey(key):
    return convert.key_from_jax(jax.random.key_data(key))


def _ulp(a, b) -> int:
    """Largest distance in float32 steps between ``a`` and ``b``."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int(np.abs(ordered(a) - ordered(b)).max())


TARGETS = {
    "isotropic_gaussian": (ja.isotropic_gaussian, ta.isotropic_gaussian, 0),
    "correlated_gaussian": (ja.correlated_gaussian, ta.correlated_gaussian, 16),
    "gaussian_mixture": (ja.gaussian_mixture, ta.gaussian_mixture, 4),
    "banana": (ja.banana, ta.banana, 0),
    "logistic_regression": (ja.logistic_regression, ta.logistic_regression, 16),
}


@pytest.mark.parametrize("name", TARGETS)
def test_targets_match(name):
    make_jax, make_port, target_ulp = TARGETS[name]
    jt, tt = make_jax(), make_port(device=CPU)
    assert (tt.dim, tt.log_z, tt.name) == (jt.dim, jt.log_z, jt.name)
    x = (3.0 * np.random.default_rng(0).standard_normal((4096, jt.dim))).astype(np.float32)
    assert _ulp(jt.log_base(x), tt.log_base(torch.from_numpy(x))) == 0
    assert _ulp(jt.log_target(x), tt.log_target(torch.from_numpy(x))) <= target_ulp
    k = jax.random.PRNGKey(4)
    jx = np.asarray(jt.sample_base(k, 512))
    tx = tt.sample_base(_tkey(k), 512).numpy()
    assert tx.shape == (512, jt.dim) and _ulp(jx, tx) <= 4


def test_gaussian_family_matches_and_thetas_convert():
    jf, tf = ja.gaussian_family(dim=3), ta.gaussian_family(dim=3, device=CPU)
    jth = jax.tree.map(lambda *xs: jnp.stack(xs),
                       *[ja.gaussian_theta(0.5 * s, 1.0 + 0.25 * s, dim=3) for s in range(3)])
    tth = convert.theta_from_jax(jth, device=CPU)
    assert tth["mean"].shape == (3, 3) and tth["sigma"].shape == (3,)
    for name in ("mean", "sigma"):
        assert np.array_equal(tth[name].numpy(), np.asarray(jth[name]))
    x = (2.0 * np.random.default_rng(1).standard_normal((256, 3))).astype(np.float32)
    for s in range(3):
        one = convert.theta_from_jax(jax.tree.map(lambda leaf: leaf[s], jth), device=CPU)
        assert one["mean"].shape == (3,) and one["sigma"].shape == ()
        jv = jf.log_target(x, jax.tree.map(lambda leaf: leaf[s], jth))
        assert _ulp(jv, tf.log_target(torch.from_numpy(x), one)) == 0
    assert _ulp(jf.log_z_fn(jth), tf.log_z_fn(tth)) <= 1


def test_logistic_data_from_the_same_key():
    """The synthetic data come from ``PRNGKey(7)`` split in three: ``x``
    within ``normal``'s 3 ULP of JAX's; ``y`` is a bit-exact uniform against
    ``sigmoid``, and a flipped label would move ``log_target`` far beyond
    the 16 ULP that ``test_targets_match`` holds it to."""
    from repro_torch import random as trandom

    kx = jax.random.split(jax.random.PRNGKey(7), 3)[0]
    tkx = trandom.split(trandom.PRNGKey(7), 3)[0]
    assert _ulp(jax.random.normal(kx, (64, 4)), trandom.normal(tkx, (64, 4))) <= 3
    assert ta.logistic_regression(device=CPU).log_z is None


@pytest.mark.parametrize("num_temps", (4, 12, 24, 100))
def test_geometric_schedule_matches(num_temps):
    tb = ta.geometric_schedule(num_temps, device=CPU)
    assert _ulp(ja.geometric_schedule(num_temps), tb) == 0
    assert _ulp(jax.jit(lambda: ja.geometric_schedule(num_temps))(), tb) <= 8
    assert float(tb[-1]) == 1.0


_jax_next_temperature = jax.jit(lambda lw, d, bp: ja.next_temperature(lw, d, bp, 0.9))


@pytest.mark.parametrize("n", (256, 1024))
@pytest.mark.parametrize("scale", (0.5, 4.0, 16.0))
def test_conditional_ess_and_next_temperature_match(n, scale):
    rng = np.random.default_rng(int(scale * 10) + n)
    delta = (scale * rng.standard_normal(n)).astype(np.float32)
    log_w = (0.5 * rng.standard_normal(n)).astype(np.float32)
    td, tw = torch.from_numpy(delta), torch.from_numpy(log_w)
    log_u = (0.37 * delta).astype(np.float32)
    assert _ulp(ja.conditional_ess(log_w, log_u), ta.conditional_ess(tw, torch.from_numpy(log_u))) \
        <= 64
    for beta_prev in (0.0, 0.3, 0.9):
        jb = float(_jax_next_temperature(log_w, delta, jnp.float32(beta_prev)))
        tb = float(ta.next_temperature(tw, td, beta_prev, 0.9))
        assert abs(tb - jb) <= 1e-5
        assert (tb == 1.0) == (jb == 1.0)


def test_adapt_step_size_matches():
    for accept in (0.0, 0.1, 0.234, 0.5, 0.574, 1.0):
        for size in (1e-4, 0.5, 3.0, 1e3):
            j = ja.adapt_step_size(jnp.float32(size), jnp.float32(accept), 0.234)
            t = ta.adapt_step_size(torch.tensor(size), torch.tensor(accept), 0.234)
            assert _ulp(j, t) <= 2


def _tempered(jt, tt, beta=0.37):
    def jlp(y):
        return (1.0 - beta) * jt.log_base(y) + beta * jt.log_target(y)

    def tlp(y):
        return (1.0 - beta) * tt.log_base(y) + beta * tt.log_target(y)

    return jlp, tlp


@pytest.mark.parametrize("name", ("isotropic_gaussian", "gaussian_mixture", "banana"))
def test_mala_gradient_matches_jax_grad(name):
    make_jax, make_port, _ = TARGETS[name]
    jlp, tlp = _tempered(make_jax(), make_port(device=CPU))
    x = (2.0 * np.random.default_rng(2).standard_normal((4096, 2))).astype(np.float32)
    jg = np.asarray(jax.grad(lambda y: jnp.sum(jlp(y)))(x))
    lp, tg = _value_and_grad(tlp, torch.from_numpy(x))
    assert not lp.requires_grad and not tg.requires_grad
    if name == "gaussian_mixture":
        np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=1e-5)
    else:
        assert np.array_equal(tg.numpy(), jg)


@pytest.mark.parametrize("move", ("rwm", "mala"))
@pytest.mark.parametrize("name", ("isotropic_gaussian", "gaussian_mixture"))
def test_moves_match_from_the_same_key(name, move):
    make_jax, make_port, _ = TARGETS[name]
    jlp, tlp = _tempered(make_jax(), make_port(device=CPU))
    n, steps = 8192, 3
    x = (2.0 * np.random.default_rng(3).standard_normal((n, 2))).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jx, jacc = jax.jit(lambda k, y: ja.MOVES[move](k, y, jlp, jnp.float32(0.8), steps))(key, x)
    tx, tacc = ta.MOVES[move](_tkey(key), torch.from_numpy(x), tlp, torch.tensor(0.8), steps)
    jx, tx = np.asarray(jx), tx.numpy()
    # the accept rate differs by the flipped decisions over N, per sweep
    flips = abs(float(jacc) - float(tacc)) * steps * n
    agree = np.any(jx != x, axis=1) == np.any(tx != x, axis=1)
    assert flips <= 1e-3 * steps * n and (~agree).mean() <= 1e-3
    np.testing.assert_allclose(tx[agree], jx[agree], rtol=0, atol=1e-5)


def test_sampler_config_from_jax():
    jspec = jax_spec_for_backend("megopolis", "xla", num_iters=12)
    jcfg = ja.SMCSamplerConfig(num_particles=512, num_temps=7, schedule="adaptive",
                               resampler=jspec, move="mala", step_size=0.3, target_cess=0.8)
    tcfg = convert.sampler_config_from_jax(jcfg)
    assert tcfg.resampler == spec_for_backend("megopolis", "reference", num_iters=12)
    for f in dataclasses.fields(jcfg):
        if f.name != "resampler":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    named = convert.sampler_config_from_jax(ja.SMCSamplerConfig(num_particles=8,
                                                                resampler="systematic"))
    assert named.resampler == "systematic"


def _same_key_chain(to, jo):
    """A run that split its keys in another order, or drew from another
    stream, would land about logZ's Monte Carlo std (0.03 at N = 1024) away:
    logZ within RUN_LOGZ_TIGHT, the resamples equal, the accept rates within
    RUN_ACCEPT_ATOL."""
    np.testing.assert_allclose(to["log_z"].numpy(), np.asarray(jo["log_z"]), rtol=0,
                               atol=RUN_LOGZ_TIGHT)
    np.testing.assert_array_equal(to["num_resamples"].numpy(), np.asarray(jo["num_resamples"]))
    np.testing.assert_allclose(to["accept"].numpy(), np.asarray(jo["accept"]), rtol=0,
                               atol=RUN_ACCEPT_ATOL)


RUNS = {
    "geometric": {},
    "adaptive": {"schedule": "adaptive"},
    "mala": {"move": "mala"},
}


@pytest.mark.parametrize("kind", RUNS)
@pytest.mark.parametrize("family", ("megopolis", "systematic"))
def test_whole_runs_on_the_reference_backends(family, kind):
    jcfg = ja.SMCSamplerConfig(num_particles=N_RUN, num_temps=12,
                               resampler=jax_spec_for_backend(family, "xla"), **RUNS[kind])
    tcfg = convert.sampler_config_from_jax(jcfg)
    assert tcfg.resampler_spec().backend == "reference"
    key = jax.random.PRNGKey(0)
    for make_jax, make_port in ((ja.isotropic_gaussian, ta.isotropic_gaussian),
                                (ja.gaussian_mixture, ta.gaussian_mixture)):
        jt, tt = make_jax(), make_port(device=CPU)
        jo = jax.jit(lambda k: ja.run_smc_sampler(k, jt, jcfg))(key)
        to = ta.run_smc_sampler(_tkey(key), tt, tcfg, device=CPU)
        jz, tz = float(jo["log_z"]), float(to["log_z"])
        assert tz == pytest.approx(jz, abs=RUN_ATOL), (jt.name, jz, tz)
        for z in (jz, tz):
            assert z == pytest.approx(jt.log_z, rel=0.1, abs=0.1)
        _same_key_chain(to, jo)
        np.testing.assert_allclose(to["betas"].numpy(), np.asarray(jo["betas"]), rtol=0,
                                   atol=1e-5)
        assert float(to["betas"][-1]) == 1.0


def test_bank_runs_on_the_reference_backends():
    jcfg = ja.SMCSamplerConfig(num_particles=256, num_temps=8,
                               resampler=jax_spec_for_backend("megopolis", "xla"))
    tcfg = convert.sampler_config_from_jax(jcfg)
    jth = jax.tree.map(lambda *xs: jnp.stack(xs),
                       *[ja.gaussian_theta(0.5 * s, 1.0 + 0.25 * s) for s in range(3)])
    key = jax.random.PRNGKey(7)
    jo = jax.jit(lambda k: ja.run_smc_sampler_bank(k, ja.gaussian_family(), jcfg,
                                                   thetas=jth))(key)
    to = ta.run_smc_sampler_bank(_tkey(key), ta.gaussian_family(device=CPU), tcfg,
                                 thetas=convert.theta_from_jax(jth, device=CPU), device=CPU)
    np.testing.assert_allclose(to["log_z"].numpy(), np.asarray(jo["log_z"]), rtol=0,
                               atol=RUN_ATOL)
    _same_key_chain(to, jo)
    assert to["particles"].shape == (3, 256, 2)
