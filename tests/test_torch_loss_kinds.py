"""The training loss of ``repro_torch.models`` beyond the per-arch checks of
``tests/test_torch_loss.py`` (whose helpers it shares), on the CPU: bfloat16
compute against ``jax.value_and_grad(repro.models.loss_fn)`` under
``jax.jit``, every layer kind in one model with remat on in both packages,
the masked targets, and remat against no remat.

Bounds, as measured on these inputs:

* bfloat16 compute over float32 parameters (qwen3, remat on, the JAX
  package's non-smoke posture): the loss within ``BF16_LOSS_RTOL`` (1e-3;
  measured: 5e-5) and each gradient leaf within ``BF16_GRAD_SHARE`` (5%) of
  its largest magnitude (measured: 2.5%): each bfloat16 product rounds to
  8 bits, and a 1-ULP difference early moves later roundings;
* every kind in one model (mamba, swa, attn, shared_attn, MoE; two loss
  chunks): ``test_torch_loss.py``'s float32 bounds, ``LOSS_RTOL`` and
  ``GRAD_ATOL``;
* the port alone: remat on equals remat off bit for bit, the loss and
  every gradient; every gradient finite for every kind (the twin of
  ``tests/test_models.py``'s ``test_loss_grad_finite_all_kinds``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as jax_arch
from repro.models.transformer import ModelConfig as JaxModelConfig
from repro_torch import convert
from repro_torch import models as tm
from repro_torch import random as trandom
from repro_torch.checkpoint import tree_leaves
from repro_torch.optim import value_and_grad
from test_torch_loss import GRAD_ATOL, LOSS_RTOL, _batch, _both, _one_torch_thread  # noqa: F401

BF16_LOSS_RTOL = 1e-3
BF16_GRAD_SHARE = 0.05


def test_bf16_loss_and_grads_are_jax():
    jcfg = dataclasses.replace(jax_arch("qwen3-0.6b").smoke, dtype=jnp.bfloat16, remat=True)
    jl, jg, tl, tg = _both(jcfg, _batch(jcfg.vocab_size, 8))
    np.testing.assert_allclose(float(tl), jl, rtol=BF16_LOSS_RTOL)
    for got, want in zip(tg, jg):
        bound = BF16_GRAD_SHARE * float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=bound)


def test_loss_ignores_masked_targets():
    """A target of -1 adds nothing: the same loss as dropping those positions'
    terms by hand, and no gradient through the masked logits."""
    cfg = dataclasses.replace(convert.model_config_from_jax(jax_arch("qwen3-0.6b").smoke),
                              dtype=torch.float32, remat=False)
    params = tm.init_params(trandom.PRNGKey(3), cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab_size, 9).items()}
    h = tm.forward(params, cfg, batch["inputs"])
    logits = tm.logits_fn(params, cfg, h).float()
    keep = batch["targets"] >= 0
    terms = torch.logsumexp(logits, -1)[keep] - torch.gather(
        logits, -1, batch["targets"].clamp_min(0).long()[..., None])[..., 0][keep]
    np.testing.assert_allclose(float(tm.loss_fn(params, cfg, batch)), float(terms.mean()),
                               rtol=1e-6)
    all_masked = dict(batch, targets=torch.full_like(batch["targets"], -1))
    assert float(tm.loss_fn(params, cfg, all_masked)) == 0.0


def _all_kinds(**kw) -> JaxModelConfig:
    """``tests/test_models.py``'s ``tiny_cfg`` with every layer kind and MoE."""
    base = dict(name="tiny", num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                vocab_size=97, loss_chunk=8, q_chunk=64,
                layer_pattern=("mamba", "swa", "attn", "shared_attn"), window=4,
                num_experts=4, top_k=2, ssm_state=8, ssm_head_dim=16, ssm_chunk=4,
                qk_norm=True, dtype=jnp.float32)
    base.update(kw)
    return JaxModelConfig(**base)


def test_every_kind_is_jax_with_remat():
    """All kinds in one model, remat on in both packages (``jax.checkpoint``
    against ``torch.utils.checkpoint``), two loss chunks."""
    jl, jg, tl, tg = _both(_all_kinds(remat=True), _batch(97, 10), key=16)
    np.testing.assert_allclose(float(tl), jl, rtol=LOSS_RTOL)
    for got, want in zip(tg, jg):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=GRAD_ATOL)


def test_remat_equals_no_remat_bit_for_bit_and_grads_are_finite():
    on = convert.model_config_from_jax(_all_kinds(remat=True))
    off = dataclasses.replace(on, remat=False)
    params = tm.init_params(trandom.PRNGKey(16), on, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(97, 11, masked=False).items()}
    l_on, g_on = value_and_grad(lambda p: tm.loss_fn(p, on, batch))(params)
    l_off, g_off = value_and_grad(lambda p: tm.loss_fn(p, off, batch))(params)
    assert np.isfinite(float(l_on))
    assert torch.equal(l_on, l_off)
    for a, b in zip(tree_leaves(g_on), tree_leaves(g_off)):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)
    # Without autograd recording, remat runs the layers plainly.
    with torch.no_grad():
        assert torch.equal(tm.loss_fn(params, on, batch), l_on)
