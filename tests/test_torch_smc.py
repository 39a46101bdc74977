"""SMC decoding on the port (``repro_torch.smc``, ``repro_torch.launch.serve``)
against ``repro.smc`` on the CPU, on the JAX package's parameters and keys.

Bounds, as measured on these inputs:

* ``random.gumbel`` draws the uniforms of ``jax.random.gumbel`` bit for bit;
  ``-log(-log(u))`` rounds as XLA-CPU's on ``GUMBEL_EQUAL_SHARE`` of the
  draws or more (measured: 77.2%), the rest within 1 ULP of the log's
  result (|diff| at most ``GUMBEL_ATOL``; ROADMAP Queue C item 9).  A
  ``categorical`` draw flips only where two entries of ``gumbel + logits``
  lie within that difference: measured, every row of every draw here
  agrees with ``jax.random.categorical`` (``ROW_AGREE_SHARE`` = 1 over
  2 x 1024 rows of 512 and 16 rows of the full 151936 vocabulary);
* ``smc_decode`` on ``backend="reference"`` (the paper's segment 32) for
  Megopolis, Metropolis and improved systematic at N = 16: tokens,
  every step's ancestors and the resample count equal to JAX's, the
  log-weights and the ESS history within ``LOGW_ATOL`` (measured: equal);
* the int32 token state through the Megopolis step on the ``cuda`` spec's
  plain version at N = 1024 bit for bit with JAX's ``pallas_interpret``
  step, at both branches (tokens and ancestors; the stats within 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_arch as jax_arch
from repro.core import spec as jspec
from repro.smc import SMCDecodeConfig as JaxSMCDecodeConfig
from repro.smc import smc_decode as jax_smc_decode
from repro_torch import convert
from repro_torch import models as tm
from repro_torch import random as trandom
from repro_torch.configs import get_arch
from repro_torch.core import spec as tspec
from repro_torch.core.spec import MegopolisSpec, spec_for_backend
from repro_torch.kernels.megopolis import megopolis as mk
from repro_torch.launch.serve import DECODE_PARTICLES, serve_once
from repro_torch.obs.telemetry import Telemetry
from repro_torch.smc import SMCDecodeConfig, ess, smc_decode

GUMBEL_EQUAL_SHARE = 0.75
GUMBEL_ATOL = 1e-6
ROW_AGREE_SHARE = 1.0
LOGW_ATOL = 1e-5
FAMILIES = ("megopolis", "metropolis", "improved_systematic")
VOCAB = 151936


@pytest.fixture(autouse=True)
def _partitionable():
    assert jax.config.jax_threefry_partitionable


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's torch ops on one thread: under the suite's parallel
    workers, OpenMP's spinning threads of every worker's small ops contend
    for the same cores (a 0.6 s test took 35 s)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tkey(key):
    return convert.key_from_jax(jax.random.key_data(key))


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_setup(n, prompt=4, seed=0):
    """JAX's ``tests/test_smc.py`` setup, with the port's copies."""
    cfg = dataclasses.replace(jax_arch("qwen3-0.6b").smoke, dtype=jnp.float32, remat=False)
    key = jax.random.PRNGKey(seed)
    params = jm.init_params(key, cfg)
    prompts = jax.random.randint(jax.random.fold_in(key, 1), (n, prompt), 0,
                                 cfg.vocab_size, jnp.int32)
    return cfg, params, prompts, key


def _port(cfg, params):
    return convert.model_config_from_jax(cfg), convert.params_from_jax(params, "cpu")


# -------------------------------------------------------------- categorical
def test_gumbel_uniforms_and_share_equal_to_jax():
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.random.gumbel(key, (256, 512)))
    got = trandom.gumbel(_tkey(key), (256, 512)).numpy()
    share = float((want.view(np.int32) == got.view(np.int32)).mean())
    assert share >= GUMBEL_EQUAL_SHARE
    assert np.abs(want - got).max() <= GUMBEL_ATOL


@pytest.mark.parametrize("rows,width", ((1024, 512), (16, VOCAB)))
def test_categorical_rows_agree_with_jax(rows, width):
    rng = np.random.default_rng(rows)
    logits = rng.standard_normal((rows, width)).astype(np.float32) * 3
    for seed in (0, 1):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.categorical(key, jnp.asarray(logits), axis=-1))
        got = trandom.categorical(_tkey(key), torch.from_numpy(logits)).numpy()
        assert float((want == got).mean()) >= ROW_AGREE_SHARE


def test_categorical_does_not_depend_on_its_chunks(monkeypatch):
    logits = torch.randn(37, 300, generator=torch.Generator().manual_seed(0))
    key = trandom.PRNGKey(7)
    whole = trandom.categorical(key, logits)
    monkeypatch.setattr(trandom, "CATEGORICAL_CHUNK", 300 * 5)
    assert torch.equal(trandom.categorical(key, logits), whole)
    monkeypatch.setattr(trandom, "CATEGORICAL_CHUNK", 1)
    assert torch.equal(trandom.categorical(key, logits), whole)


# ------------------------------------------------- whole runs against JAX's
def _record_ancestors(monkeypatch):
    """Every step's ancestors on both sides: JAX's through a debug callback
    inside its scan, the port's from its ``Resampler.step``."""
    jax_seen, port_seen = [], []
    jax_real, port_real = jspec.Resampler.step, tspec.Resampler.step

    def jax_step(self, *args, **kwargs):
        out = jax_real(self, *args, **kwargs)
        jax.debug.callback(lambda a: jax_seen.append(np.asarray(a)), out[1], ordered=True)
        return out

    def port_step(self, *args, **kwargs):
        out = port_real(self, *args, **kwargs)
        port_seen.append(out[1].numpy().copy())
        return out

    monkeypatch.setattr(jspec.Resampler, "step", jax_step)
    monkeypatch.setattr(tspec.Resampler, "step", port_step)
    return jax_seen, port_seen


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("target_temp,thr", ((0.5, 0.9), (0.7, 0.5)), ids=("eager", "default"))
def test_smc_decode_matches_jax_on_the_reference_backend(family, target_temp, thr, monkeypatch):
    n, new = 16, 12
    cfg, params, prompts, key = _jax_setup(n)
    tcfg, tparams = _port(cfg, params)
    _, caches = jm.prefill(params, cfg, prompts, max_seq=4 + new)
    _, tcaches = tm.prefill(tparams, tcfg, _t(prompts), max_seq=4 + new)
    jax_cfg = JaxSMCDecodeConfig(
        num_particles=n, max_new_tokens=new, target_temp=target_temp, ess_threshold=thr,
        resampler=jspec.spec_for_backend(family, "reference", num_iters=16))
    port_cfg = SMCDecodeConfig(
        num_particles=n, max_new_tokens=new, target_temp=target_temp, ess_threshold=thr,
        resampler=spec_for_backend(family, "reference", num_iters=16))
    jax_seen, port_seen = _record_ancestors(monkeypatch)
    dkey = jax.random.fold_in(key, 2)
    tokens, log_w, stats = jax_smc_decode(params, cfg, jax_cfg, caches, prompts[:, -1], 4, dkey)
    jax.effects_barrier()
    ttokens, tlog_w, tstats = smc_decode(tparams, tcfg, port_cfg, tcaches, _t(prompts[:, -1]),
                                         4, _tkey(dkey))
    assert ttokens.dtype == torch.int32 and ttokens.shape == (n, new)
    np.testing.assert_array_equal(ttokens.numpy(), np.asarray(tokens))
    assert len(jax_seen) == len(port_seen) == new
    for got, want in zip(port_seen, jax_seen):
        np.testing.assert_array_equal(got, want)
    assert int(tstats["num_resamples"]) == int(stats["num_resamples"])
    np.testing.assert_allclose(tlog_w.numpy(), np.asarray(log_w), rtol=0, atol=LOGW_ATOL)
    np.testing.assert_allclose(tstats["ess_history"].numpy(), np.asarray(stats["ess_history"]),
                               rtol=LOGW_ATOL, atol=LOGW_ATOL)


# ------------------------------------ JAX's tests/test_smc.py, on the port
def _setup(n, prompt=4, seed=0):
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").smoke, dtype=torch.float32, remat=False)
    key = trandom.PRNGKey(seed)
    params = tm.init_params(key, cfg, device="cpu")
    prompts = trandom.randint(trandom.fold_in(key, 1), (n, prompt), 0, cfg.vocab_size)
    return cfg, params, prompts, key


def _reference(family):
    return spec_for_backend(family, "reference", num_iters=16)


def test_ess_bounds():
    assert abs(float(ess(torch.zeros(10))) - 10.0) < 1e-4
    concentrated = torch.tensor([0.0] + [-100.0] * 9)
    assert float(ess(concentrated)) < 1.01


@pytest.mark.parametrize("family", FAMILIES)
def test_smc_decode_runs_and_is_finite(family):
    cfg, params, prompts, key = _setup(16)
    new = 12
    _, caches = tm.prefill(params, cfg, prompts, max_seq=4 + new)
    smc = SMCDecodeConfig(num_particles=16, max_new_tokens=new, resampler=_reference(family),
                          target_temp=0.5, ess_threshold=0.9)
    tokens, log_w, stats = smc_decode(params, cfg, smc, caches, prompts[:, -1], 4,
                                      trandom.fold_in(key, 2))
    assert tokens.shape == (16, new)
    assert bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all())
    assert bool(torch.isfinite(log_w).all())
    assert int(stats["num_resamples"]) >= 1


def test_resampling_resets_weights_and_keeps_population_valid():
    cfg, params, prompts, key = _setup(32)
    _, caches = tm.prefill(params, cfg, prompts, max_seq=4 + 8)
    smc = SMCDecodeConfig(num_particles=32, max_new_tokens=8, resampler=_reference("megopolis"),
                          target_temp=0.3, ess_threshold=0.99)
    _, _, stats = smc_decode(params, cfg, smc, caches, prompts[:, -1], 4,
                             trandom.fold_in(key, 3))
    assert float(stats["ess_history"].max()) <= 32.0 + 1e-3
    assert int(stats["num_resamples"]) >= 4


def test_greedy_limit_matches_argmax_decoding():
    cfg, params, prompts, key = _setup(8)
    _, caches = tm.prefill(params, cfg, prompts, max_seq=4 + 5)
    smc = SMCDecodeConfig(num_particles=8, max_new_tokens=5, resampler=_reference("megopolis"),
                          proposal_temp=1e-4, target_temp=1e-4, ess_threshold=0.1)
    _, log_w, stats = smc_decode(params, cfg, smc, caches, prompts[:, -1], 4,
                                 trandom.fold_in(key, 4))
    assert int(stats["num_resamples"]) == 0
    torch.testing.assert_close(log_w, torch.zeros(8), rtol=0, atol=1e-3)


@pytest.mark.parametrize("n,spec", ((4, _reference("megopolis")),
                                    (DECODE_PARTICLES, MegopolisSpec(num_iters=16))),
                         ids=("reference", "cuda_plain"))
def test_ancestor_gather_coherence(n, spec):
    """Identical prompts and near-greedy sampling: every particle continues
    identically (the cache gather keeps each particle's own history)."""
    cfg, params, _, key = _setup(n)
    same = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32).expand(n, 4).contiguous()
    _, caches = tm.prefill(params, cfg, same, max_seq=4 + 6)
    smc = SMCDecodeConfig(num_particles=n, max_new_tokens=6, resampler=spec,
                          proposal_temp=1e-4, target_temp=1e-4)
    tokens, _, _ = smc_decode(params, cfg, smc, caches, same[:, -1], 4, trandom.fold_in(key, 5))
    assert bool((tokens == tokens[0]).all())


# ---------------------------------------- the kernels' path on the CPU
def test_a_name_resolves_to_the_kernels():
    spec = SMCDecodeConfig(num_particles=1024, max_new_tokens=4).resampler_spec()
    assert spec == MegopolisSpec(num_iters=16) and spec.backend == "cuda"
    assert spec.segment == 1024
    named = SMCDecodeConfig(num_particles=1024, max_new_tokens=4, resampler="residual")
    assert named.resampler_spec().backend == "cuda"


def test_cuda_spec_below_a_tile_raises():
    """N = 64 is not a whole tile of the kernels: ``check_bank``'s rule holds
    on the CPU too, and nothing falls back to the reference algorithm."""
    cfg, params, prompts, key = _setup(64)
    _, caches = tm.prefill(params, cfg, prompts, max_seq=4 + 2)
    smc = SMCDecodeConfig(num_particles=64, max_new_tokens=2)
    with pytest.raises(ValueError, match="N % 1024 == 0"):
        smc_decode(params, cfg, smc, caches, prompts[:, -1], 4, key)


def _token_state(seed, n=1024, t=32):
    return np.random.default_rng(seed).integers(0, VOCAB, (n, t)).astype(np.int32)


@pytest.mark.parametrize("spread,thr,fires", ((3.0, 0.9, True), (0.05, 0.5, False)),
                         ids=("resample", "keep"))
def test_int32_token_state_through_the_step_matches_pallas_interpret(spread, thr, fires):
    """The decode's state, ``int32[N, T]`` token ids (every one a float32
    subnormal as a bit pattern), through the ``cuda`` spec's step on the
    CPU (the kernel's plain version) and JAX's ``pallas_interpret`` step."""
    tokens = _token_state(1)
    lw = (np.random.default_rng(2).standard_normal(1024) * spread).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jax_r = jspec.MegopolisSpec(num_iters=16, segment=1024, backend="pallas_interpret").build()
    want_p, want_a, want_s = jax_r.step(key, jnp.asarray(lw), jnp.asarray(tokens), thr)
    mk.reset_launch_counts()
    got_p, got_a, got_s = MegopolisSpec(num_iters=16).build().step(
        _tkey(key), _t(lw), _t(tokens), thr)
    assert got_p.dtype == torch.int32 and bool(got_s.resampled) == fires
    assert float(want_s.resampled) == float(got_s.resampled)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(float(got_s.ess_norm), float(want_s.ess_norm), rtol=1e-5)
    assert mk.megopolis_step.launches == 0  # the plain version on the CPU


# ---------------------------------------------------- telemetry, serving
def test_telemetry_adds_the_step_stats_and_changes_nothing():
    cfg, params, prompts, key = _setup(16)

    def run(telemetry):
        _, caches = tm.prefill(params, cfg, prompts, max_seq=4 + 5)
        smc = SMCDecodeConfig(num_particles=16, max_new_tokens=5,
                              resampler=_reference("megopolis"), target_temp=0.5,
                              ess_threshold=0.9)
        return smc_decode(params, cfg, smc, caches, prompts[:, -1], 4, trandom.fold_in(key, 6),
                          telemetry=telemetry)

    tokens, log_w, stats = run(False)
    t_tokens, t_log_w, t_stats, tel = run(True)
    assert isinstance(tel, Telemetry) and tel.steps.ess_norm.shape == (5,)
    assert torch.equal(tokens, t_tokens) and torch.equal(log_w, t_log_w)
    assert int(tel.steps.resampled.sum()) == int(t_stats["num_resamples"])


def test_serve_once_on_the_cpu():
    out = serve_once("qwen3-0.6b", num_particles=DECODE_PARTICLES, prompt_len=4, new_tokens=4,
                     target_temp=0.5, device="cpu")
    assert out["tokens"].shape == (DECODE_PARTICLES, 4) and out["tokens"].dtype == torch.int32
    assert bool(((out["tokens"] >= 0) & (out["tokens"] < 512)).all())
    assert bool(torch.isfinite(out["log_weights"]).all()) and out["num_resamples"] >= 1


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' runs")
    from repro_torch.launch.serve import main

    with pytest.raises(RuntimeError, match="device='cuda'"):
        main(["--arch", "qwen3-0.6b"])
