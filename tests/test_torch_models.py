"""The port's LM stack (``repro_torch.models``) against ``repro.models`` on the
CPU, on the JAX package's own parameters (``convert.params_from_jax``) and
the same inputs, in float32.

Bounds, as measured on these inputs:

* ``forward``, ``prefill`` (logits and every cache leaf) and ``decode_step``
  (logits and caches) within rtol 1e-5 / atol 1e-5 of JAX's for every
  layer kind the port runs (``attn``, banded ``swa``, ``shared_attn``),
  qk-norm, the four MLP types, q-chunking and ``embeds_input`` (measured:
  within 4.1e-6 on logits of magnitude ~4; the matrix products sum in
  another order than XLA's);
* ``init_params`` from the same key within 3 ULP of JAX's, leaf for leaf
  (``random.normal``'s bound, ROADMAP Queue C item 9; measured: 3, with
  95.3% of the values equal);
* the port alone: decode equals forward, the ring cache stays bounded,
  q-chunking is exact, the window masks what it must, with the JAX
  package's own tolerances (``tests/test_models.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_arch as jax_arch
from repro.models.transformer import logits_fn as jax_logits_fn
from repro_torch import convert
from repro_torch import models as tm
from repro_torch import random as trandom
from repro_torch.configs import get_arch
from repro_torch.models import layers
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.attention import _sdpa, attention, init_attention
from repro_torch.models.transformer import logits_fn

RTOL = ATOL = 1e-5
INIT_ULP = 3
F32 = dict(dtype=jnp.float32, remat=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's torch ops on one thread: under the suite's parallel
    workers, OpenMP's spinning threads of every worker's small ops contend
    for the same cores (a 0.6 s test took 35 s)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_cfg(**kw):
    """The JAX package's test model (``tests/test_models.py``)."""
    base = dict(name="tiny", num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
                d_ff=128, vocab_size=97, loss_chunk=8, q_chunk=64)
    base.update(kw)
    return jm.ModelConfig(**base)


def smoke(arch_id):
    return dataclasses.replace(jax_arch(arch_id).smoke, **F32)


#: name -> a JAX config: each layer kind, the MLP types, chunking, embeds.
CASES = {
    "attn_qknorm_swiglu": lambda: tiny_cfg(qk_norm=True, **F32),
    "swa_banded_chunks": lambda: tiny_cfg(layer_pattern=("swa",), window=4, q_chunk=4, **F32),
    "shared_attn": lambda: tiny_cfg(layer_pattern=("attn", "shared_attn"), qk_norm=True, **F32),
    "q_chunked": lambda: tiny_cfg(q_chunk=4, **F32),
    "qwen3_smoke": lambda: smoke("qwen3_0_6b"),
    "gemma3_smoke_geglu_swa": lambda: smoke("gemma3_27b"),
    "danube_smoke_swa": lambda: smoke("h2o_danube_3_4b"),
    "nemotron_smoke_squared_relu": lambda: smoke("nemotron_4_15b"),
    "musicgen_smoke_gelu_embeds": lambda: smoke("musicgen_large"),
    "chameleon_smoke_embeds_qknorm": lambda: smoke("chameleon_34b"),
}


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _inputs(cfg, key, shape):
    if cfg.embeds_input:
        return jax.random.normal(key, (*shape, cfg.d_model), jnp.float32)
    return jax.random.randint(key, shape, 0, cfg.vocab_size, jnp.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_forward_decode_match_jax(case):
    cfg = CASES[case]()
    tcfg = convert.model_config_from_jax(cfg)
    params = jm.init_params(jax.random.PRNGKey(9), cfg)
    tparams = convert.params_from_jax(params, "cpu")
    x = _inputs(cfg, jax.random.PRNGKey(10), (2, 12))
    nxt = _inputs(cfg, jax.random.PRNGKey(11), (2, 2))
    max_seq = 16

    _close(tm.forward(tparams, tcfg, _t(x)), jm.forward(params, cfg, x), "forward")
    logits, caches = jm.prefill(params, cfg, x, max_seq=max_seq)
    tlogits, tcaches = tm.prefill(tparams, tcfg, _t(x), max_seq=max_seq)
    _close(tlogits, logits, "prefill logits")
    for got, want in zip(jax.tree.leaves(convert.params_to_jax(tcaches)), jax.tree.leaves(caches)):
        _close(got, want, "prefill caches")
    for t in range(2):
        logits, caches = jm.decode_step(params, cfg, nxt[:, t:t + 1], caches, jnp.int32(12 + t))
        tlogits, tcaches = tm.decode_step(tparams, tcfg, _t(nxt[:, t:t + 1]), tcaches, 12 + t)
        _close(tlogits, logits, f"decode logits, step {t}")
        for got, want in zip(jax.tree.leaves(convert.params_to_jax(tcaches)),
                             jax.tree.leaves(caches)):
            _close(got, want, f"decode caches, step {t}")


def _ulp(a, b) -> int:
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int(np.abs(ordered(a) - ordered(b)).max())


@pytest.mark.parametrize("case", ["qwen3_smoke", "gemma3_smoke_geglu_swa", "shared_attn",
                                  "musicgen_smoke_gelu_embeds"])
def test_init_params_within_ulp_of_jax(case):
    cfg = CASES[case]()
    key = jax.random.PRNGKey(4)
    want = jm.init_params(key, cfg)
    got = tm.init_params(convert.key_from_jax(jax.random.key_data(key)),
                         convert.model_config_from_jax(cfg), device="cpu")
    got_leaves, want_leaves = jax.tree.leaves(convert.params_to_jax(got)), jax.tree.leaves(want)
    assert jax.tree.structure(convert.params_to_jax(got)) == jax.tree.structure(want)
    for g, w in zip(got_leaves, want_leaves):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert _ulp(g, w) <= INIT_ULP


def test_gqa_heads_follow_repeat_interleave():
    """Query head i reads KV head i // g: the JAX package's ``jnp.repeat``
    order, written out with ``torch.repeat_interleave``."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 3, 8, 16, generator=g)
    k, v = torch.randn(2, 5, 2, 16, generator=g), torch.randn(2, 5, 2, 16, generator=g)
    mask = torch.zeros(3, 5)
    kr, vr = torch.repeat_interleave(k, 4, dim=2), torch.repeat_interleave(v, 4, dim=2)
    scores = torch.einsum("bqhd,bshd->bhqs", q, kr) * 16**-0.5 + mask
    want = torch.einsum("bhqs,bshd->bqhd", torch.softmax(scores, -1), vr).reshape(2, 3, 128)
    torch.testing.assert_close(_sdpa(q, k, v, mask, torch.float32), want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------ the port alone (JAX's tests)
def _tcfg(**kw):
    return convert.model_config_from_jax(tiny_cfg(**kw, **F32))


def _tokens(seed, shape, vocab=97):
    return trandom.randint(trandom.PRNGKey(seed), shape, 0, vocab)


@pytest.mark.parametrize("pattern,extra", [(("attn",), {}), (("swa",), {"window": 4}),
                                           (("attn", "shared_attn"), {})],
                         ids=["attn", "swa", "shared_attn"])
def test_decode_matches_forward(pattern, extra):
    cfg = _tcfg(layer_pattern=pattern, qk_norm=True, **extra)
    params = tm.init_params(trandom.PRNGKey(9), cfg, device="cpu")
    tokens, nxt = _tokens(10, (2, 12)), _tokens(11, (2, 2))
    h = tm.forward(params, cfg, tokens)
    logits_p, caches = tm.prefill(params, cfg, tokens, max_seq=16)
    torch.testing.assert_close(logits_p, logits_fn(params, cfg, h[:, -1]), rtol=2e-3, atol=2e-4)
    h_full = tm.forward(params, cfg, torch.cat([tokens, nxt], dim=1))
    for t in range(2):
        lg, caches = tm.decode_step(params, cfg, nxt[:, t:t + 1], caches, 12 + t)
        torch.testing.assert_close(lg, logits_fn(params, cfg, h_full[:, 12 + t]), rtol=2e-3,
                                   atol=2e-4)


def test_ring_cache_stays_bounded():
    """A sliding-window layer's ring is O(window), not O(seq), and decoding
    past the window keeps it so while matching forward."""
    cfg = _tcfg(layer_pattern=("swa",), window=4)
    assert tm.init_cache(cfg, batch=2, max_seq=1024, device="cpu")[0]["kv"][0].shape[1] == 4
    params = tm.init_params(trandom.PRNGKey(12), cfg, device="cpu")
    tokens, nxt = _tokens(13, (2, 6)), _tokens(14, (2, 5))
    _, caches = tm.prefill(params, cfg, tokens, max_seq=64)
    h_full = tm.forward(params, cfg, torch.cat([tokens, nxt], dim=1))
    for t in range(5):
        lg, caches = tm.decode_step(params, cfg, nxt[:, t:t + 1], caches, 6 + t)
        assert all(c["kv"][0].shape[1] == 4 for c in caches)
        torch.testing.assert_close(lg, logits_fn(params, cfg, h_full[:, 6 + t]), rtol=2e-3,
                                   atol=2e-4)


def test_q_chunking_is_exact():
    cfg_1, cfg_2 = _tcfg(q_chunk=4), _tcfg(q_chunk=64)
    params = tm.init_params(trandom.PRNGKey(3), cfg_1, device="cpu")
    tokens = _tokens(4, (2, 16))
    torch.testing.assert_close(tm.forward(params, cfg_1, tokens),
                               tm.forward(params, cfg_2, tokens), rtol=1e-4, atol=1e-5)


def test_window_ge_seq_equals_global():
    cfg_swa, cfg_glb = _tcfg(layer_pattern=("swa",), window=64), _tcfg()
    params = tm.init_params(trandom.PRNGKey(5), cfg_swa, device="cpu")
    tokens = _tokens(6, (2, 16))
    torch.testing.assert_close(tm.forward(params, cfg_swa, tokens),
                               tm.forward(params, cfg_glb, tokens), rtol=1e-5, atol=1e-6)


def test_window_blocks_long_range():
    """A token beyond the window does not move the last position's output."""
    cfg = _tcfg()
    p = init_attention(trandom.PRNGKey(7), cfg, device="cpu")
    x = trandom.normal(trandom.PRNGKey(8), (1, 12, cfg.d_model))
    pos = torch.arange(12, dtype=torch.int32).expand(1, 12)
    out1, _ = attention(p, cfg, x, pos, window=4)
    x2 = x.clone()
    x2[:, 0] += 10.0
    out2, _ = attention(p, cfg, x2, pos, window=4)
    torch.testing.assert_close(out1[:, -1], out2[:, -1], rtol=1e-5, atol=1e-6)
    assert not torch.allclose(out1[:, 0], out2[:, 0])


def test_fp8_kv_cache_close_to_full_precision():
    cfg = _tcfg()
    cfg8 = dataclasses.replace(cfg, cache_dtype=torch.float8_e4m3fn)
    params = tm.init_params(trandom.PRNGKey(21), cfg, device="cpu")
    toks = _tokens(22, (2, 6))
    logits, caches = tm.prefill(params, cfg, toks, max_seq=8)
    _, caches8 = tm.prefill(params, cfg8, toks, max_seq=8)
    assert caches8[0]["kv"][0].dtype == torch.float8_e4m3fn
    nxt = logits.argmax(-1)[:, None].to(torch.int32)
    l1, _ = tm.decode_step(params, cfg, nxt, caches, 6)
    l8, _ = tm.decode_step(params, cfg8, nxt, caches8, 6)
    assert float((l1 - l8).abs().mean()) < 0.15
    assert float((l1.argmax(-1) == l8.argmax(-1)).float().mean()) >= 0.5


@pytest.mark.parametrize("arch_id,item", [("dbrx_132b", "A11b"), ("zamba2_2_7b", "A11c"),
                                          ("mamba2_1_3b", "A11c")])
def test_unported_layers_raise_naming_their_item(arch_id, item):
    cfg = get_arch(arch_id).smoke
    for call in (lambda: tm.init_params(trandom.PRNGKey(0), cfg, device="cpu"),
                 lambda: tm.init_cache(cfg, 2, 8, device="cpu"),
                 lambda: tm.forward({}, cfg, torch.zeros(2, 4, dtype=torch.int32))):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            call()


def test_tensor_entries_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' runs")
    cfg = _tcfg()
    key = trandom.PRNGKey(0)
    for call in (lambda: tm.init_params(key, cfg),
                 lambda: tm.init_cache(cfg, 2, 8),
                 lambda: layers.init_linear(key, 4, 8),
                 lambda: layers.init_rmsnorm(4),
                 lambda: layers.init_embedding(key, 16, 4),
                 lambda: layers.rope_frequencies(8, 1e4),
                 lambda: init_attention(key, cfg),
                 lambda: mlp_mod.init_mlp(key, 4, 8, "swiglu")):
        with pytest.raises(RuntimeError, match="device='cuda'"):
            call()


def test_logits_fn_matches_jax_on_the_same_hidden_states():
    cfg = tiny_cfg(**F32)
    params = jm.init_params(jax.random.PRNGKey(1), cfg)
    h = jax.random.normal(jax.random.PRNGKey(2), (3, cfg.d_model), jnp.float32)
    _close(logits_fn(convert.params_from_jax(params, "cpu"), convert.model_config_from_jax(cfg),
                     _t(h)), jax_logits_fn(params, cfg, h), "logits_fn")
