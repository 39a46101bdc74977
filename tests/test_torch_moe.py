"""The port's MoE layer (``repro_torch.models.moe``) and its archs (dbrx,
llama4) against ``repro.models`` on the CPU, on the JAX package's own
parameters (``convert.params_from_jax``) and inputs made from a seed with
numpy, in float32.

Bounds, as measured on these inputs:

* ``moe`` within ``RTOL`` / ``ATOL`` (1e-5) of JAX's ``moe`` on the dropless
  path (t <= 256) and on the capacity path (t = 1024 tokens at smoke width,
  the decode's N), with the same assignments kept: the routing (top-k, its
  ties, the stable sort, the positions, the capacity) is exact, and the
  combine adds each token's k contributions in JAX's order (measured:
  within 2.1e-6 on outputs of magnitude ~7; the products sum in another
  order than XLA's; 302 of 2048 and 594 of 1024 assignments dropped);
* top-1 MoE with ample capacity within the JAX package's bound (rtol 2e-3 /
  atol 2e-4) of every token through its argmax expert's dense MLP;
* prefill logits and ``decode_step`` of the dbrx and llama4 smoke archs
  within ``RTOL`` / ``ATOL`` of JAX's (measured: within 4.4e-6 on logits of
  magnitude ~3.4); ``aux_load_balance_loss`` within 1e-6;
* ``random.normal`` in chunks of its flat counters equal to the whole
  draw (the DBRX expert weights' init on the card).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_arch as jax_arch
from repro.models import moe as jmoe
from repro.models.transformer import ModelConfig as JaxModelConfig
from repro_torch import convert
from repro_torch import models as tm
from repro_torch import random as trandom
from repro_torch.models import moe as tmoe

RTOL = ATOL = 1e-5
DENSE_RTOL, DENSE_ATOL = 2e-3, 2e-4
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


def _cfg(**kw):
    """The JAX package's test model (``tests/test_models.py``) with experts."""
    base = dict(name="tiny", num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                d_ff=128, vocab_size=97, num_experts=4, top_k=2, **F32)
    base.update(kw)
    return JaxModelConfig(**base)


def _pair(cfg, seed):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), cfg)
    return jp, convert.params_from_jax(jp, "cpu"), convert.model_config_from_jax(cfg)


def _jax_kept(jp, cfg, x2, cap):
    """JAX's kept assignments, in its own ops (``_moe_local``'s lines)."""
    logits = x2 @ jp["router"]["w"]
    _, eids = jax.lax.top_k(logits, cfg.top_k)
    flat_e = eids.reshape(-1)
    order = jnp.argsort(flat_e)
    counts = jnp.bincount(flat_e, length=cfg.num_experts)
    starts = jnp.cumsum(counts) - counts
    pos = jnp.arange(flat_e.shape[0]) - starts[flat_e[order]]
    return np.asarray(order), np.asarray(pos < cap)


@pytest.mark.parametrize("tokens,kw", [
    (2 * 8, {}),                                                     # dropless, top-2
    (4 * 256, {}),                                                   # capacity path
    (4 * 256, dict(num_experts=8, top_k=1, num_shared_experts=1)),   # llama4's layout
], ids=("dropless", "capacity", "top1-shared"))
def test_moe_matches_jax_with_the_same_kept_assignments(tokens, kw):
    cfg = _cfg(**kw)
    jp, tp, tcfg = _pair(cfg, 12)
    rng = np.random.default_rng(tokens)
    # one offset shared by every token skews the routing, so that the
    # capacity path drops assignments
    x = rng.standard_normal((4, tokens // 4, cfg.d_model)) + rng.standard_normal(cfg.d_model)
    x = x.astype(np.float32)
    want = jax.jit(lambda p, x: jmoe.moe(p, cfg, x))(jp, jnp.asarray(x))
    got = tmoe.moe(tp, tcfg, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    cap = tmoe.capacity(tokens, tcfg)
    x2 = _t(x).reshape(tokens, -1)
    _, eids = tmoe.route(tp, tcfg, x2)
    order, _, _, keep = tmoe.dispatch(tcfg, eids, cap)
    j_order, j_keep = _jax_kept(jp, cfg, jnp.asarray(x2.numpy()), cap)
    np.testing.assert_array_equal(order.numpy(), j_order)
    np.testing.assert_array_equal(keep.numpy(), j_keep)
    counts = torch.bincount(eids.reshape(-1), minlength=tcfg.num_experts)
    n_drop = int((counts - cap).clamp_min(0).sum())
    assert n_drop == int((~keep).sum())
    assert (n_drop > 0) == (tokens > tmoe.DROPLESS_TOKENS)


@pytest.mark.parametrize("t", [1, 16, 256, 257, 1024, 4096])
def test_capacity_is_jax_formula(t):
    cfg = _cfg(num_experts=16, top_k=4)
    want = t * 4 if t <= 256 else int(max(1, (t * 4 + 15) // 16) * 1.25)
    assert tmoe.capacity(t, convert.model_config_from_jax(cfg)) == want


def test_route_breaks_ties_toward_the_lower_index_as_top_k():
    cfg = _cfg(num_experts=8, top_k=3)
    tcfg = convert.model_config_from_jax(cfg)
    rng = np.random.default_rng(0)
    w = np.round(rng.standard_normal((64, 8)), 0).astype(np.float32)  # many tied logits
    x2 = np.eye(64, dtype=np.float32)[:16] + np.eye(64, dtype=np.float32)[16:32]
    _, eids = tmoe.route({"router": {"w": _t(w)}}, tcfg, _t(x2))
    _, want = jax.lax.top_k(jnp.asarray(x2) @ jnp.asarray(w), 3)
    np.testing.assert_array_equal(eids.numpy(), np.asarray(want))


def test_moe_top1_matches_dense_expert_choice():
    """Top-1 routing with ample capacity: MoE equals every token through its
    argmax expert's SwiGLU MLP."""
    cfg = _cfg(num_experts=4, top_k=1)
    _, tp, tcfg = _pair(cfg, 12)
    x = _t(np.random.default_rng(13).standard_normal((2, 8, cfg.d_model)).astype(np.float32))
    out = tmoe.moe(tp, tcfg, x, capacity_factor=4.0).reshape(-1, cfg.d_model)
    x2 = x.reshape(-1, cfg.d_model)
    eid = (x2 @ tp["router"]["w"]).argmax(-1)
    for t in range(x2.shape[0]):
        e = int(eid[t])
        h = x2[t] @ tp["w1"]["w"][e]
        g = x2[t] @ tp["w3"]["w"][e]
        ref = (torch.nn.functional.silu(g) * h) @ tp["w2"]["w"][e]
        np.testing.assert_allclose(out[t].numpy(), ref.numpy(), rtol=DENSE_RTOL, atol=DENSE_ATOL)


def test_aux_loss_and_init_match_jax():
    cfg = _cfg(num_experts=4, top_k=2, num_shared_experts=1)
    jp, tp, tcfg = _pair(cfg, 3)
    x = np.random.default_rng(4).standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(float(tmoe.aux_load_balance_loss(tp, tcfg, _t(x))),
                               float(jmoe.aux_load_balance_loss(jp, cfg, jnp.asarray(x))),
                               rtol=1e-6)
    mine = tmoe.init_moe(trandom.PRNGKey(3), tcfg, device="cpu")
    assert jax.tree.structure(convert.params_to_jax(mine)) == jax.tree.structure(jp)
    for got, want in zip(jax.tree.leaves(convert.params_to_jax(mine)), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-7)


def test_moe_sharded_names_its_item():
    cfg = convert.model_config_from_jax(_cfg())
    with pytest.raises(NotImplementedError, match="item A11f"):
        tmoe.moe_sharded({}, cfg, torch.zeros(1, 2, cfg.d_model))


@pytest.mark.parametrize("arch_id", ["dbrx_132b", "llama4_maverick_400b_a17b"])
def test_smoke_arch_prefill_and_decode_step_match_jax(arch_id):
    cfg = dataclasses.replace(jax_arch(arch_id).smoke, **F32)
    tcfg = convert.model_config_from_jax(cfg)
    params = jm.init_params(jax.random.PRNGKey(0), cfg)
    tparams = convert.params_from_jax(params, "cpu")
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill, static_argnums=(1, 3))(params, cfg, jnp.asarray(toks), 12)
    tl, tc = tm.prefill(tparams, tcfg, _t(toks), 12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    nxt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    jl2, _ = jax.jit(jm.decode_step, static_argnums=1)(params, cfg, jnp.asarray(nxt), jc, 7)
    tl2, _ = tm.decode_step(tparams, tcfg, _t(nxt), tc, 7)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=RTOL, atol=ATOL)


def test_normal_does_not_depend_on_its_chunks(monkeypatch):
    """An expert weight's draw (10^9 elements at DBRX's width) runs in chunks
    of the flat counters; every chunking gives the whole draw's values."""
    key = trandom.PRNGKey(11)
    whole = trandom.normal(key, (3, 40, 7))
    monkeypatch.setattr(trandom, "NORMAL_CHUNK", 97)
    assert torch.equal(trandom.normal(key, (3, 40, 7)), whole)
    monkeypatch.setattr(trandom, "NORMAL_CHUNK", 1)
    assert torch.equal(trandom.normal(key, (3, 40, 7)), whole)
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(11), (3, 40, 7)))
    np.testing.assert_array_max_ulp(whole.numpy(), want, maxulp=3)
