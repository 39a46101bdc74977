"""The port's training loss (``repro_torch.models.loss_fn``) and its gradients
against ``jax.value_and_grad(repro.models.loss_fn)`` on the CPU, on the JAX
package's own parameters (``convert.params_from_jax``), the JAX side under
``jax.jit``; every layer kind: attn (qwen3), swa (gemma3), mamba (mamba2),
mamba + shared_attn (zamba2) and MoE (dbrx, llama4 with its shared expert
and dense layers between), at the smoke configs, and a batch whose targets
hold -1 (masked out).

Bounds, as measured on these inputs: the loss within ``LOSS_RTOL`` (1e-6;
measured: within 1.5e-7) and every gradient leaf within ``GRAD_ATOL``
(1e-5; measured: within 1.5e-6 on leaves of magnitude up to ~1): the
products and sums add in other orders (XLA's, MKL's).  Both packages start
from the same parameters.  ``tests/test_torch_loss_kinds.py`` holds
bfloat16, every kind in one model with remat, and remat against no remat.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_arch as jax_arch
from repro_torch import convert
from repro_torch import models as tm
from repro_torch import random as trandom
from repro_torch.checkpoint import tree_leaves
from repro_torch.optim import value_and_grad

LOSS_RTOL = 1e-6
GRAD_ATOL = 1e-5
ARCHS = ("qwen3-0.6b", "gemma3-27b", "mamba2-1.3b", "zamba2-2.7b", "dbrx-132b",
         "llama4-maverick-400b-a17b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: under the suite's parallel workers, OpenMP's
    spinning threads of every worker's small ops contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(vocab: int, seed: int, b: int = 2, s: int = 16, masked: bool = True) -> dict:
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:].copy()}
    if masked:
        batch["targets"][0, 3] = -1
        batch["targets"][1, -4:] = -1
    return batch


def _both(jcfg, batch, key: int = 1):
    """(JAX loss, JAX grads, port loss, port grads) from one set of params,
    the port's ``init_params`` (JAX's own draws them about 2 s slower)."""
    tcfg = convert.model_config_from_jax(jcfg)
    tp = tm.init_params(trandom.PRNGKey(key), tcfg, device="cpu")
    jp = jax.tree.map(jnp.asarray, convert.params_to_jax(tp))
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: jm.loss_fn(p, jcfg, b)))(jp, batch)
    tl, tg = value_and_grad(lambda p, b: tm.loss_fn(p, tcfg, b))(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    return float(jl), [np.asarray(x, np.float32) for x in jleaves], tl, tleaves


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_are_jax(arch):
    jcfg = dataclasses.replace(jax_arch(arch).smoke, dtype=jnp.float32, remat=False)
    jl, jg, tl, tg = _both(jcfg, _batch(jcfg.vocab_size, 7))
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(float(tl), jl, rtol=LOSS_RTOL)
    for got, want in zip(tg, jg):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=GRAD_ATOL)


