"""The port's Mamba2/SSD block (``repro_torch.models.mamba2``) and its archs
(mamba2, zamba2) against ``repro.models`` on the CPU, on the JAX package's
own parameters (``convert.params_from_jax``) and inputs made from a seed with
numpy, in float32.

Bounds, as measured on these inputs:

* ``_ssd_chunked`` within ``SSD_RTOL`` / ``SSD_ATOL`` (2e-5 / 2e-6) of JAX's
  (measured: within 4.8e-7 on outputs of magnitude ~10): the port runs the
  inter-chunk recurrence as a loop over the chunks, JAX's
  ``associative_scan`` adds the same terms as a tree; both within the JAX
  package's own bound (rtol 2e-4, atol 2e-5) of the naive per-step
  recurrence;
* ``mamba_block`` (output and every cache leaf, the ragged padding
  included) and ``mamba_decode_step`` within ``RTOL`` / ``ATOL`` (1e-5) of
  JAX's (measured: within 1.5e-6);
* prefill logits and ``decode_step`` of the mamba2 and zamba2 smoke archs
  within ``RTOL`` / ``ATOL`` of JAX's (measured: within 3.2e-6 on logits of
  magnitude ~3.5);
* the port alone: decode equals the chunked forward (the JAX package's own
  tolerance, rtol 2e-3 / atol 2e-4), for the ``mamba`` pattern and Zamba2's
  ``mamba`` + ``shared_attn`` with SSM and KV caches side by side;
* ``smc_decode`` of ``mamba2-smoke`` on ``backend="reference"``: tokens,
  every step's ancestors and the resample count equal to JAX's, the
  log-weights within 1e-5 (the SSM and conv leaves of the cache gathered as
  the KV leaves are).
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
from repro.models import mamba2 as jmamba
from repro.models.transformer import ModelConfig as JaxModelConfig
from repro.smc import SMCDecodeConfig as JaxSMCDecodeConfig
from repro.smc import smc_decode as jax_smc_decode
from repro_torch import convert
from repro_torch import models as tm
from repro_torch import random as trandom
from repro_torch.core import spec as tspec
from repro_torch.core.spec import spec_for_backend
from repro_torch.models import mamba2 as tmamba
from repro_torch.smc import SMCDecodeConfig, smc_decode

SSD_RTOL, SSD_ATOL = 2e-5, 2e-6
NAIVE_RTOL, NAIVE_ATOL = 2e-4, 2e-5
RTOL = ATOL = 1e-5
DECODE_RTOL, DECODE_ATOL = 2e-3, 2e-4
LOGW_ATOL = 1e-5
F32 = dict(dtype=jnp.float32, remat=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: under the suite's parallel workers, OpenMP's
    spinning threads of every worker's small ops contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


def _tiny(**kw):
    """The JAX package's test model (``tests/test_models.py``) with a mamba
    layer."""
    base = dict(name="tiny", num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                d_ff=128, vocab_size=97, layer_pattern=("mamba",), ssm_state=8,
                ssm_head_dim=16, ssm_chunk=4, **F32)
    base.update(kw)
    return JaxModelConfig(**base)


def _ssd_inputs(seed, bsz=2, s=16, h=3, p=4, n=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    log_da = -np.log1p(np.exp(rng.standard_normal((bsz, s, h)))).astype(np.float32)
    b_ssm = rng.standard_normal((bsz, s, n)).astype(np.float32)
    c_ssm = rng.standard_normal((bsz, s, n)).astype(np.float32)
    return x, log_da, b_ssm, c_ssm


def _naive_ssm(x, log_da, b_ssm, c_ssm):
    """``tests/test_models.py``'s per-step recurrence, in float64."""
    bsz, s, h, p = x.shape
    state = np.zeros((bsz, h, p, b_ssm.shape[-1]))
    ys = []
    for t in range(s):
        state = state * np.exp(log_da[:, t])[..., None, None] + np.einsum(
            "bhp,bn->bhpn", x[:, t], b_ssm[:, t])
        ys.append(np.einsum("bhpn,bn->bhp", state, c_ssm[:, t]))
    return np.stack(ys, axis=1), state


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_matches_jax_and_the_naive_recurrence(chunk):
    args = _ssd_inputs(chunk)
    y, final = tmamba._ssd_chunked(*map(_t, args), chunk)
    jy, jfinal = jax.jit(jmamba._ssd_chunked, static_argnums=4)(*map(jnp.asarray, args), chunk)
    _close(y, jy, SSD_RTOL, SSD_ATOL)
    _close(final, jfinal, SSD_RTOL, SSD_ATOL)
    y_ref, final_ref = _naive_ssm(*args)
    _close(y, y_ref, NAIVE_RTOL, NAIVE_ATOL)
    _close(final, final_ref, NAIVE_RTOL, NAIVE_ATOL)


def test_segsum_masks_to_exact_zeros():
    x = _t(np.random.default_rng(3).standard_normal((2, 6)).astype(np.float32))
    decay = torch.exp(tmamba._segsum(x))
    upper = torch.triu(torch.ones(6, 6, dtype=torch.bool), diagonal=1)
    assert bool((decay[:, upper] == 0).all()) and bool((decay[:, ~upper] > 0).all())
    _close(tmamba._segsum(x), jmamba._segsum(jnp.asarray(x.numpy())))


def test_softplus_is_jax_logaddexp_at_every_scale():
    x = np.array([-80, -30, -5, -1e-3, 0, 1e-3, 5, 19.9, 20.1, 30, 80], dtype=np.float32)
    got, want = tmamba.softplus(_t(x)).numpy(), np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[-1] == want[-1] == np.float32(80)


@pytest.mark.parametrize("heads", [1, 2, 8, 64, 128])
def test_a_log_linspace_within_an_ulp_of_jax(heads):
    """``jnp.linspace``'s formula in float32; XLA-CPU rounds some entries of
    its fused program one ULP off that formula (measured: none at 1, 2, 8
    and 128 heads, 5 of 64 at 64, Mamba2-1.3B's)."""
    got = tmamba._linspace_f32(1.0, float(heads), heads).numpy()
    want = np.asarray(jnp.linspace(1.0, float(heads), heads, dtype=jnp.float32))
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    if heads in (1, 2, 8, 128):
        np.testing.assert_array_equal(got, want)


def test_init_mamba_leaves_equal_jax_within_random_normal():
    """Every leaf within ``random.normal``'s bound of JAX's (ROADMAP Queue C
    item 9); ``a_log`` within 2 ULP (the linspace's ULP and ``log``'s)."""
    cfg = _tiny()
    jp = jmamba.init_mamba(jax.random.PRNGKey(1), cfg)
    tp = tmamba.init_mamba(trandom.PRNGKey(1), convert.model_config_from_jax(cfg), device="cpu")
    assert jax.tree.structure(jp) == jax.tree.structure(convert.params_to_jax(tp))
    np.testing.assert_array_max_ulp(tp["a_log"].numpy(), np.asarray(jp["a_log"]), maxulp=2)
    for got, want in zip(jax.tree.leaves(convert.params_to_jax(tp)), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("s", [8, 10])  # 10: ragged, padded to the chunk
def test_mamba_block_and_decode_step_match_jax(s):
    cfg = _tiny()
    tcfg = convert.model_config_from_jax(cfg)
    jp = jmamba.init_mamba(jax.random.PRNGKey(1), cfg)
    tp = convert.params_from_jax(jp, "cpu")
    x = np.random.default_rng(s).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    jy, jcache = jax.jit(lambda p, x: jmamba.mamba_block(p, cfg, x, chunk=4))(jp, jnp.asarray(x))
    ty, tcache = tmamba.mamba_block(tp, tcfg, _t(x), chunk=4)
    _close(ty, jy)
    for name in jcache:
        _close(tcache[name], jcache[name])
    x1 = np.random.default_rng(s + 1).standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jy1, jc1 = jax.jit(lambda *a: jmamba.mamba_decode_step(a[0], cfg, *a[1:]))(
        jp, jnp.asarray(x1), jcache)
    ty1, tc1 = tmamba.mamba_decode_step(tp, tcfg, _t(x1), tcache)
    _close(ty1, jy1)
    for name in jc1:
        _close(tc1[name], jc1[name])


@pytest.mark.parametrize("pattern", [("mamba",), ("mamba", "mamba", "shared_attn")],
                         ids=("mamba", "zamba"))
def test_decode_equals_forward(pattern):
    """The port alone: prefill then one-token decode steps reproduce the
    chunked forward's logits, SSM and KV caches side by side."""
    cfg = convert.model_config_from_jax(_tiny(num_layers=3, layer_pattern=pattern))
    params = tm.init_params(trandom.PRNGKey(4), cfg, device="cpu")
    toks = _t(np.random.default_rng(5).integers(0, 97, (2, 10)).astype(np.int32))
    full = tm.logits_fn(params, cfg, tm.forward(params, cfg, toks))
    logits, caches = tm.prefill(params, cfg, toks[:, :4], max_seq=10)
    assert [set(c) for c in caches] == [{"conv_x", "conv_b", "conv_c", "ssm"} if k == "mamba"
                                        else {"kv"} for k in cfg.layer_kinds]
    _close(logits, full[:, 3].numpy(), DECODE_RTOL, DECODE_ATOL)
    for t in range(4, 10):
        logits, caches = tm.decode_step(params, cfg, toks[:, t:t + 1], caches, t)
        _close(logits, full[:, t].numpy(), DECODE_RTOL, DECODE_ATOL)


@pytest.mark.parametrize("arch_id", ["mamba2_1_3b", "zamba2_2_7b"])
def test_smoke_arch_prefill_and_decode_step_match_jax(arch_id):
    cfg = dataclasses.replace(jax_arch(arch_id).smoke, **F32)
    tcfg = convert.model_config_from_jax(cfg)
    params = jm.init_params(jax.random.PRNGKey(0), cfg)
    tparams = convert.params_from_jax(params, "cpu")
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill, static_argnums=(1, 3))(params, cfg, jnp.asarray(toks), 12)
    tl, tc = tm.prefill(tparams, tcfg, _t(toks), 12)
    _close(tl, jl)
    nxt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    jl2, jc2 = jax.jit(jm.decode_step, static_argnums=1)(params, cfg, jnp.asarray(nxt), jc, 7)
    tl2, tc2 = tm.decode_step(tparams, tcfg, _t(nxt), tc, 7)
    _close(tl2, jl2)
    for got, want in zip(jax.tree.leaves(convert.params_to_jax(tc2)), jax.tree.leaves(jc2)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_smc_decode_of_mamba2_smoke_matches_jax_on_the_reference_backend(monkeypatch):
    n, new, prompt = 16, 8, 4
    cfg = dataclasses.replace(jax_arch("mamba2-1.3b").smoke, **F32)
    key = jax.random.PRNGKey(0)
    params = jm.init_params(key, cfg)
    prompts = jax.random.randint(jax.random.fold_in(key, 1), (n, prompt), 0, cfg.vocab_size,
                                 jnp.int32)
    tcfg, tparams = convert.model_config_from_jax(cfg), convert.params_from_jax(params, "cpu")
    _, caches = jax.jit(jm.prefill, static_argnums=(1, 3))(params, cfg, prompts, prompt + new)
    _, tcaches = tm.prefill(tparams, tcfg, _t(prompts), max_seq=prompt + new)
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
    kw = dict(num_particles=n, max_new_tokens=new, target_temp=0.5, ess_threshold=0.9)
    jcfg = JaxSMCDecodeConfig(resampler=jspec.spec_for_backend("megopolis", "reference",
                                                               num_iters=16), **kw)
    pcfg = SMCDecodeConfig(resampler=spec_for_backend("megopolis", "reference", num_iters=16),
                           **kw)
    dkey = jax.random.fold_in(key, 2)
    tokens, log_w, stats = jax_smc_decode(params, cfg, jcfg, caches, prompts[:, -1], prompt,
                                          dkey)
    jax.effects_barrier()
    ttokens, tlog_w, tstats = smc_decode(tparams, tcfg, pcfg, tcaches, _t(prompts[:, -1]),
                                         prompt, convert.key_from_jax(jax.random.key_data(dkey)))
    np.testing.assert_array_equal(ttokens.numpy(), np.asarray(tokens))
    assert len(jax_seen) == len(port_seen) == new
    for got, want in zip(port_seen, jax_seen):
        np.testing.assert_array_equal(got, want)
    assert int(tstats["num_resamples"]) == int(stats["num_resamples"]) >= 1
    np.testing.assert_allclose(tlog_w.numpy(), np.asarray(log_w), rtol=0, atol=LOGW_ATOL)
