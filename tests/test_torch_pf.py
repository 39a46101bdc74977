"""The port's particle filter (``repro_torch.pf``) against ``repro.pf``.

* Replay: the JAX filter runs step by step; its pre-resample particles,
  weights and resample key go through the port's resample stage, which must
  return the same particles and ancestors bit for bit (Alg. 6), or hold the
  step's stats and ancestors to the bounds of ``test_torch_megopolis.py``
  (conditional SIR).
* Whole runs: the UNGM noise of the port is within 3 ULP of
  ``jax.random.normal``, and torch's ``exp`` within 1 ULP of XLA's, so the
  particles drift apart by ULPs and a rare accept flips.  A flip moves a
  post-resample mean by at most the particle range over N (about 60/4096 at
  N = 4096), so the estimates are held to ``WHOLE_RUN_ATOL``, two flips'
  worth; ``test_run_filter_matches`` prints the measured gap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.spec import MegopolisSpec as JaxSpec
from repro.core.spec import MetropolisSpec as JaxMetropolisSpec
from repro.pf import filter as jf
from repro.pf import models as jm
from repro_torch import convert
from repro_torch.core.spec import MegopolisSpec, MetropolisSpec
from repro_torch.pf import filter as tf
from repro_torch.pf import models as tm
from repro_torch.pf.metrics import resample_ratio, rmse

N, B, T = 4096, 16, 25
WHOLE_RUN_ATOL = 0.05
SIM_ATOL = 1e-4  # a few ULP of values up to ~30
STATS_RTOL = 2e-6
MAX_MISMATCH_RATE = 1e-3


@pytest.fixture(autouse=True)
def _partitionable():
    assert jax.config.jax_threefry_partitionable


def _jax_spec(b=B):
    return JaxSpec(num_iters=b, segment=1024, backend="pallas_interpret")


def _tkey(key):
    return convert.key_from_jax(jax.random.key_data(key))


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.int32)


@pytest.fixture(scope="module")
def sim():
    key = jax.random.PRNGKey(1)
    xs, zs = jf.simulate(key, jm.ungm(), T)
    return key, np.array(xs), np.array(zs)


def test_simulate_matches(sim):
    key, xs, zs = sim
    txs, tzs = tf.simulate(_tkey(key), tm.ungm(), T, device="cpu")
    np.testing.assert_allclose(txs.numpy(), xs, atol=SIM_ATOL, rtol=0)
    np.testing.assert_allclose(tzs.numpy(), zs, atol=SIM_ATOL, rtol=0)


def _replay_alg6(zs, jspec, tspec, seed):
    """Run the JAX Alg. 6 filter step by step; its pre-resample particles,
    weights and resample key go through the port's fused resample stage,
    which must return the same particles and ancestors bit for bit."""
    model = jm.ungm()
    jpf = jf.ParticleFilter(model, N, resampler=jspec)
    tpf = tf.ParticleFilter(tm.ungm(), N, resampler=tspec)
    stage1 = jax.jit(lambda k, x, z, t: (lambda y: (y, model.likelihood(z, y, t)))(
        model.transition(k, x, t)))
    k0, k = jax.random.split(jax.random.PRNGKey(seed))
    particles = model.init(k0, N)
    flushed = 0
    for t in range(1, T + 1):
        k, ks = jax.random.split(k)
        k_pred, k_res = jax.random.split(ks)
        x, w = stage1(k_pred, particles, zs[t - 1], jnp.float32(t))
        jx, ja = jpf._built.apply(k_res, w, x)
        tx, ta = tpf._built.apply(_tkey(k_res), convert.array_from_jax(w, device="cpu"),
                                  convert.array_from_jax(x, device="cpu"))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja), err_msg=f"step {t}")
        np.testing.assert_array_equal(_bits(tx.numpy()), _bits(jx), err_msg=f"step {t}")
        flushed += int((np.asarray(w) == 0).sum())
        particles = jx
    assert flushed > 0  # the run reaches likelihoods XLA flushes to zero


@pytest.mark.parametrize("seed", (2, 3))
def test_replay_alg6_resample_stage_bits(sim, seed):
    _replay_alg6(sim[2], _jax_spec(), MegopolisSpec(num_iters=B), seed)


def test_replay_alg6_metropolis_bits(sim):
    """Table 2's baseline column: the same replay with Alg. 2."""
    _replay_alg6(sim[2], JaxMetropolisSpec(num_iters=B, backend="pallas_interpret"),
                 MetropolisSpec(num_iters=B), 6)


def test_replay_conditional_resample_stage(sim):
    _, _, zs = sim
    model = jm.ungm()
    jpf = jf.ParticleFilter(model, N, resampler=_jax_spec(), ess_threshold=0.5)
    tpf = tf.ParticleFilter(tm.ungm(), N, resampler=MegopolisSpec(num_iters=B),
                            ess_threshold=0.5)
    k0, k = jax.random.split(jax.random.PRNGKey(4))
    particles = model.init(k0, N)
    log_w = jnp.zeros(N)
    total = mismatched = fired = 0
    for t in range(1, T + 1):
        k, ks = jax.random.split(k)
        k_pred, k_res = jax.random.split(ks)
        x = model.transition(k_pred, particles, jnp.float32(t))
        log_w = log_w + jnp.log(jnp.maximum(model.likelihood(zs[t - 1], x, jnp.float32(t)),
                                            1e-30))
        jx, ja, js = jpf._built.step(k_res, log_w, x, 0.5)
        tx, ta, ts = tpf._built.step(_tkey(k_res),
                                     convert.array_from_jax(log_w, device="cpu"),
                                     convert.array_from_jax(x, device="cpu"), 0.5)
        assert float(ts.resampled) == float(js.resampled), f"step {t}"
        np.testing.assert_allclose(float(ts.ess_norm), float(js.ess_norm), rtol=STATS_RTOL)
        total += N
        mismatched += int((ta.numpy() != np.asarray(ja)).sum())
        fired += int(js.resampled)
        log_w = jnp.where(js.ess_norm < 0.5, jnp.zeros_like(log_w), log_w)
        particles = jx
    assert fired > 0 and mismatched / total <= MAX_MISMATCH_RATE


@pytest.mark.parametrize("thr", (None, 0.5))
def test_run_filter_matches(sim, thr, capsys):
    key, xs, zs = sim
    jpf = jf.ParticleFilter(jm.ungm(), N, resampler=_jax_spec(), ess_threshold=thr)
    tpf = tf.ParticleFilter(tm.ungm(), N, resampler=MegopolisSpec(num_iters=B),
                            ess_threshold=thr)
    jest, jtel = jf.run_filter(key, jpf, jnp.asarray(zs), telemetry=True)
    test, ttel = tf.run_filter(_tkey(key), tpf, torch.from_numpy(zs), telemetry=True,
                               device="cpu")
    assert test.shape == (T,)
    with capsys.disabled():
        gap = float(np.abs(test.numpy() - np.asarray(jest)).max())
        print(f"\nrun_filter (threshold {thr}) vs JAX: max |estimate gap| {gap:.3g}")
    np.testing.assert_allclose(test.numpy(), np.asarray(jest), atol=WHOLE_RUN_ATOL, rtol=0)
    np.testing.assert_array_equal(ttel.steps.resampled.numpy(), np.asarray(jtel.steps.resampled))
    np.testing.assert_allclose(ttel.steps.ess_norm.numpy(), np.asarray(jtel.steps.ess_norm),
                               rtol=1e-3)
    assert abs(rmse(test.numpy(), xs) - rmse(np.asarray(jest), xs)) <= WHOLE_RUN_ATOL


@pytest.mark.parametrize("thr", (None, 0.5))
def test_run_filter_bank_matches(thr):
    s, t_steps = 3, 15
    key = jax.random.PRNGKey(5)
    thetas = {"amp": np.float32([6.0, 8.0, 10.0]), "obs_var": np.float32([0.5, 1.0, 2.0])}
    obs = np.stack([np.asarray(jf.simulate(k, jm.ungm_family(), t_steps,
                                           theta={n: v[i] for n, v in thetas.items()})[1])
                    for i, k in enumerate(jax.random.split(key, s))])
    jpf = jf.ParticleFilter(jm.ungm_family(), N, resampler=_jax_spec(), ess_threshold=thr)
    tpf = tf.ParticleFilter(tm.ungm_family(), N, resampler=MegopolisSpec(num_iters=B),
                            ess_threshold=thr)
    jest, jtel = jf.run_filter_bank(key, jpf, jnp.asarray(obs),
                                    {n: jnp.asarray(v) for n, v in thetas.items()},
                                    telemetry=True)
    test, ttel = tf.run_filter_bank(_tkey(key), tpf, torch.from_numpy(obs),
                                    convert.theta_from_jax(thetas, device="cpu"),
                                    telemetry=True, device="cpu")
    assert test.shape == (s, t_steps) and ttel.steps.ess_norm.shape == (s, t_steps)
    np.testing.assert_allclose(test.numpy(), np.asarray(jest), atol=WHOLE_RUN_ATOL, rtol=0)
    np.testing.assert_array_equal(ttel.steps.resampled.numpy(), np.asarray(jtel.steps.resampled))


@pytest.mark.parametrize("thr", (None, 0.5))
def test_run_filter_metropolis_matches(sim, thr, capsys):
    """Whole runs with Alg. 2, one filter and a bank of 2, against JAX,
    within ``WHOLE_RUN_ATOL`` as the Megopolis runs."""
    key, xs, zs = sim
    jspec = JaxMetropolisSpec(num_iters=B, backend="pallas_interpret")
    jpf = jf.ParticleFilter(jm.ungm(), N, resampler=jspec, ess_threshold=thr)
    tpf = tf.ParticleFilter(tm.ungm(), N, resampler=MetropolisSpec(num_iters=B),
                            ess_threshold=thr)
    jest = jf.run_filter(key, jpf, jnp.asarray(zs[:15]))
    test = tf.run_filter(_tkey(key), tpf, torch.from_numpy(zs[:15]), device="cpu")
    obs = np.stack([zs[:8], zs[:8] * 0.5])
    jbank = jf.run_filter_bank(key, jpf, jnp.asarray(obs))
    tbank = tf.run_filter_bank(_tkey(key), tpf, torch.from_numpy(obs), device="cpu")
    with capsys.disabled():
        gap = max(float(np.abs(test.numpy() - np.asarray(jest)).max()),
                  float(np.abs(tbank.numpy() - np.asarray(jbank)).max()))
        print(f"\nmetropolis filter (threshold {thr}) vs JAX: max |estimate gap| {gap:.3g}")
    np.testing.assert_allclose(test.numpy(), np.asarray(jest), atol=WHOLE_RUN_ATOL, rtol=0)
    np.testing.assert_allclose(tbank.numpy(), np.asarray(jbank), atol=WHOLE_RUN_ATOL, rtol=0)


def test_bank_row_follows_single_filter(sim):
    """Row s of the bank runs the single filter's key chain."""
    key, _, zs = sim
    tpf = tf.ParticleFilter(tm.ungm(), N, resampler=MegopolisSpec(num_iters=8))
    obs = torch.from_numpy(np.stack([zs[:10], zs[:10] * 0.5]))
    bank = tf.run_filter_bank(_tkey(key), tpf, obs, device="cpu")
    keys = convert.key_from_jax(jax.random.key_data(jax.random.split(key, 2)))
    for r in range(2):
        single = tf.run_filter(keys[r], tpf, obs[r], device="cpu")
        np.testing.assert_allclose(bank[r].numpy(), single.numpy(), atol=1e-5, rtol=0)


def test_run_filter_timed(sim):
    key, _, zs = sim
    jpf = jf.ParticleFilter(jm.ungm(), N, resampler=_jax_spec(8))
    tpf = tf.ParticleFilter(tm.ungm(), N, resampler=MegopolisSpec(num_iters=8))
    jest, _ = jf.run_filter_timed(key, jpf, jnp.asarray(zs[:8]))
    test, times = tf.run_filter_timed(_tkey(key), tpf, torch.from_numpy(zs[:8]), device="cpu")
    np.testing.assert_allclose(test.numpy(), np.asarray(jest), atol=WHOLE_RUN_ATOL, rtol=0)
    assert set(times) == {"predict_update", "resample", "estimate"}
    assert 0.0 <= resample_ratio(times) <= 1.0


def test_entries_need_a_card_unless_cpu_is_asked(sim):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    key, _, zs = sim
    tpf = tf.ParticleFilter(tm.ungm(), N, resampler=MegopolisSpec(num_iters=4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.run_filter(_tkey(key), tpf, torch.from_numpy(zs))
    with pytest.raises(RuntimeError):
        tf.run_filter_bank(_tkey(key), tpf, torch.from_numpy(zs[None]))
    with pytest.raises(RuntimeError):
        tf.simulate(_tkey(key), tm.ungm(), 3)
    with pytest.raises(RuntimeError):
        tm.ungm().init(_tkey(key), N)


@pytest.mark.parametrize("kwargs", ({"checkpoint": object()}, {"with_ess": True}))
def test_unported_run_filter_options_raise(sim, kwargs):
    """``with_ess`` is not ported; ``checkpoint`` is, and refuses anything
    but a ``CheckpointPolicy``."""
    key, _, zs = sim
    tpf = tf.ParticleFilter(tm.ungm(), N, resampler=MegopolisSpec(num_iters=4))
    with pytest.raises(TypeError if "checkpoint" in kwargs else NotImplementedError):
        tf.run_filter(_tkey(key), tpf, torch.from_numpy(zs), device="cpu", **kwargs)


def test_particle_filter_validates():
    # a registry name resolves through coerce_spec with the JAX filter's B of 30
    assert tf.ParticleFilter(tm.ungm(), N, resampler="metropolis").spec == \
        MetropolisSpec(num_iters=30)
    with pytest.raises(TypeError):
        tf.ParticleFilter(tm.ungm(), N, resampler=object())
    assert tf.ParticleFilter(tm.ungm(), N, resampler=MetropolisSpec(num_iters=4)).spec == \
        MetropolisSpec(num_iters=4)
    with pytest.raises(ValueError):
        tf.ParticleFilter(tm.ungm(), N, ess_threshold=1.5)
    assert tf.ParticleFilter(tm.ungm(), N).spec == MegopolisSpec(num_iters=30)


def test_likelihood_flushes_subnormals():
    x = torch.tensor([0.0, 0.0, 0.0])
    z = torch.tensor([13.0, 13.5, 20.0])  # exp(-r²/2) is subnormal beyond ~13.2
    w = tm.ungm().likelihood(z, x, torch.tensor(1.0))
    want = np.asarray(jax.jit(jm.ungm().likelihood)(jnp.asarray(z.numpy()), jnp.zeros(3),
                                                    jnp.float32(1.0)))
    np.testing.assert_array_equal(_bits(w.numpy()), _bits(want))
    assert w[0] > 0 and w[1] == 0 and w[2] == 0


# ------------------------------------------------------------------- convert
def test_convert_keys_round_trip():
    keys = jax.random.split(jax.random.PRNGKey(9), 5)
    data = np.asarray(jax.random.key_data(keys))
    tkeys = convert.key_from_jax(data)
    assert tkeys.dtype == torch.int64 and tkeys.shape == (5, 2)
    back = convert.key_to_jax(tkeys)
    assert back.dtype == np.uint32 and (back == data).all()
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(jax.random.split(
        jax.random.wrap_key_data(back[0])))), np.asarray(jax.random.key_data(
            jax.random.split(keys[0]))))
    with pytest.raises(ValueError):
        convert.key_from_jax(np.zeros((2, 3), np.uint32))


def test_convert_arrays_and_theta_round_trip():
    x = np.array([1.5, -0.0, 1e-39, np.inf, np.nan], np.float32)
    t = convert.array_from_jax(jnp.asarray(x), device="cpu")
    np.testing.assert_array_equal(_bits(convert.array_to_jax(t)), _bits(x))
    theta = jm.ungm_theta(amp=7.0, obs_var=2.0)
    back = convert.theta_to_jax(convert.theta_from_jax(theta, device="cpu"))
    assert {k: float(v) for k, v in back.items()} == {"amp": 7.0, "obs_var": 2.0}


def test_convert_arrays_need_a_card_unless_cpu_is_asked():
    """``array_from_jax``/``theta_from_jax`` follow the device rule: with no
    device they make CUDA tensors, and raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.array_from_jax(np.zeros(4, np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.theta_from_jax(jm.ungm_theta(amp=7.0, obs_var=2.0))
    assert convert.array_from_jax(np.zeros(4, np.float32), device="cpu").device.type == "cpu"


def test_convert_spec_round_trip():
    spec = convert.spec_from_jax(_jax_spec(32))
    assert spec == MegopolisSpec(num_iters=32)
    assert convert.spec_from_jax(JaxSpec(**convert.spec_to_jax(spec))) == spec
    assert convert.spec_from_jax(JaxSpec(num_iters=8, backend="reference")) == \
        MegopolisSpec(num_iters=8, segment=32, backend="reference")
