"""The port's optimiser (``repro_torch.optim``) against ``repro.optim`` on the
CPU, on trees made from a seed with numpy (the JAX side under ``jax.jit``).

Bounds, as measured on these inputs:

* ``cosine_schedule`` within ``LR_RTOL`` (1e-6; measured: equal, or 1 ULP
  where ``cos`` rounds otherwise) of JAX's over warmup, decay and past the
  end;
* ``global_norm`` and the clipped gradients within ``NORM_RTOL`` (1e-6):
  each leaf's sum adds in the library's own order (XLA's and ``torch.sum``'s
  differ);
* five ``adamw_update`` steps, with and without clipping and weight decay,
  float32 moments: parameters and moments within ``ADAM_RTOL`` /
  ``ADAM_ATOL`` (1e-5 / 1e-7; measured: parameters within 8e-8 relative,
  moments within 1.5e-5 relative where they cancel to near zero, always
  inside the absolute bound): XLA's fused elementwise code rounds some
  products in the last bit otherwise; bfloat16 moments within one bfloat16
  ULP (``BF16_RTOL`` 2^-7 relative; measured: equal), where a 1-ULP float32
  difference could round a moment the other way;
* ``microbatch_grads`` over 1, 2 and 4 microbatches against the full batch
  (port against port) and against JAX's ``microbatch_grads`` within
  ``GRAD_RTOL`` / ``GRAD_ATOL`` (1e-5 / 1e-6); with 1 microbatch it is the
  full-batch ``value_and_grad`` bit for bit;
* ``compress_and_correct``: the wire tensor and the residual bit for bit,
  over three steps of error feedback, dense and top-k leaves, ties at the
  threshold included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import (
    AdamWConfig as JaxAdamWConfig,
    adamw_init as jax_adamw_init,
    adamw_update as jax_adamw_update,
    clip_by_global_norm as jax_clip,
    cosine_schedule as jax_cosine_schedule,
    global_norm as jax_global_norm,
    microbatch_grads as jax_microbatch_grads,
)
from repro.optim.compression import (
    CompressionConfig as JaxCompressionConfig,
    compress_and_correct as jax_compress_and_correct,
)
from repro_torch import convert
from repro_torch.checkpoint import tree_leaves
from repro_torch.optim import (
    AdamWConfig,
    CompressionConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    compress_and_correct,
    compress_init,
    cosine_schedule,
    global_norm,
    microbatch_grads,
    value_and_grad,
)

LR_RTOL = 1e-6
NORM_RTOL = 1e-6
ADAM_RTOL, ADAM_ATOL = 1e-5, 1e-7
BF16_RTOL = 2.0**-7
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: under the suite's parallel workers, OpenMP's
    spinning threads of every worker's small ops contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(seed, scale=1.0):
    """A parameter-like tree: matrices (decayed), vectors (not), a list."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"w": f(16, 8), "norm": {"scale": f(8)},
            "layers": [{"a": f(4, 5, 3)}, {}, {"b": f(7), "c": f(3, 3)}]}


def _t(tree):
    return convert.params_from_jax(tree, "cpu")


def _close(got, want, rtol, atol=0.0):
    got_l, want_l = tree_leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), rtol=rtol,
                                   atol=atol)


def test_cosine_schedule_is_jax():
    cfg = AdamWConfig(warmup_steps=10, total_steps=50)
    jcfg = JaxAdamWConfig(warmup_steps=10, total_steps=50)
    steps = np.arange(0, 60, dtype=np.int32)
    want = jax.jit(jax.vmap(lambda s: jax_cosine_schedule(jcfg, s)))(steps)
    got = torch.stack([cosine_schedule(cfg, torch.tensor(int(s), dtype=torch.int32))
                       for s in steps])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LR_RTOL)
    assert float(cosine_schedule(cfg, 3)) == float(cosine_schedule(cfg, torch.tensor(3)))


def test_global_norm_and_clip_are_jax():
    grads = _tree(1, scale=3.0)
    np.testing.assert_allclose(float(global_norm(_t(grads))),
                               float(jax.jit(jax_global_norm)(grads)), rtol=NORM_RTOL)
    for max_norm in (1.0, 1e6):
        got, gnorm = clip_by_global_norm(_t(grads), max_norm)
        want, wnorm = jax.jit(lambda g: jax_clip(g, max_norm))(grads)
        np.testing.assert_allclose(float(gnorm), float(wnorm), rtol=NORM_RTOL)
        _close(got, want, NORM_RTOL)
    # no clipping below the bound: the gradients themselves
    got, _ = clip_by_global_norm(_t(grads), 1e6)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(grads)):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip,wd", [(1.0, 0.1), (0.0, 0.0)])
def test_adamw_update_is_jax_over_five_steps(moments, clip, wd):
    kw = dict(warmup_steps=2, total_steps=5, clip_norm=clip, weight_decay=wd,
              moment_dtype=moments)
    cfg, jcfg = AdamWConfig(**kw), JaxAdamWConfig(**kw)
    params = _tree(2)
    jparams, jstate = params, jax_adamw_init(params, jnp.dtype(moments))
    tparams, tstate = _t(params), adamw_init(_t(params), moments)
    assert tstate["step"].dtype == torch.int32
    assert all(m.dtype == getattr(torch, moments) for m in tree_leaves(tstate["mu"]))
    jstep = jax.jit(lambda p, g, s: jax_adamw_update(jcfg, p, g, s))
    rtol = ADAM_RTOL if moments == "float32" else BF16_RTOL
    for step in range(5):
        grads = _tree(10 + step, scale=0.5)
        jparams, jstate, jm = jstep(jparams, grads, jstate)
        tparams, tstate, tm = adamw_update(cfg, tparams, _t(grads), tstate)
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=LR_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=NORM_RTOL)
        _close(tparams, jparams, ADAM_RTOL, ADAM_ATOL)
        _close(tstate["mu"], jstate["mu"], rtol, ADAM_ATOL)
        _close(tstate["nu"], jstate["nu"], rtol, ADAM_ATOL)


def test_adamw_state_round_trips_through_convert():
    """Both packages can start from one optimiser state, bf16 moments too."""
    params = _tree(3)
    jstate = jax_adamw_init(params, jnp.bfloat16)
    jstate = jax.jit(lambda p, g, s: jax_adamw_update(JaxAdamWConfig(), p, g, s)[1])(
        params, _tree(4), jstate)
    tstate = convert.opt_state_from_jax(jstate, "cpu")
    assert tstate["step"].dtype == torch.int32 and int(tstate["step"]) == 1
    back = convert.opt_state_to_jax(tstate)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert np.asarray(jnp.asarray(g, w.dtype)).tobytes() == np.asarray(w).tobytes()


def _linear_loss(params, batch):
    """A small model: ``mean((tanh(x W) · v - y)²)`` over the rows."""
    h = torch.tanh(batch["x"] @ params["w"])
    return torch.mean((h @ params["v"] - batch["y"]) ** 2)


def _jax_linear_loss(params, batch):
    h = jnp.tanh(batch["x"] @ params["w"])
    return jnp.mean((h @ params["v"] - batch["y"]) ** 2)


def _regression(seed):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "v": rng.standard_normal((5,)).astype(np.float32)}
    batch = {"x": rng.standard_normal((8, 6)).astype(np.float32),
             "y": rng.standard_normal((8,)).astype(np.float32)}
    return params, batch


@pytest.mark.parametrize("n", [1, 2, 4])
def test_microbatch_grads_match_the_full_batch_and_jax(n):
    params, batch = _regression(5)
    tparams, tbatch = _t(params), _t(batch)
    loss, grads = microbatch_grads(_linear_loss, tparams, tbatch, n)
    full_loss, full_grads = value_and_grad(_linear_loss)(tparams, tbatch)
    if n == 1:
        assert torch.equal(loss, full_loss)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads),
                                                     tree_leaves(full_grads)))
    np.testing.assert_allclose(float(loss), float(full_loss), rtol=GRAD_RTOL)
    for a, b in zip(tree_leaves(grads), tree_leaves(full_grads)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    wl, wg = jax.jit(lambda p, b: jax_microbatch_grads(_jax_linear_loss, p, b, n))(params,
                                                                                  batch)
    np.testing.assert_allclose(float(loss), float(wl), rtol=GRAD_RTOL)
    _close(grads, wg, GRAD_RTOL, GRAD_ATOL)
    assert not any(leaf.requires_grad for leaf in tree_leaves(tparams))


def test_value_and_grad_gives_zeros_for_unused_leaves():
    params = {"w": torch.ones(3), "unused": torch.ones(2)}
    loss, grads = value_and_grad(lambda p: (p["w"] ** 2).sum())(params)
    assert float(loss) == 3.0
    assert torch.equal(grads["w"], torch.full((3,), 2.0))
    assert torch.equal(grads["unused"], torch.zeros(2))


def _compress_tree(seed):
    rng = np.random.default_rng(seed)
    big = rng.standard_normal((80, 64)).astype(np.float32)
    big[3, :7] = big[0, 0]  # ties at any threshold they reach
    return {"big": big, "wide": rng.standard_normal((5000,)).astype(np.float32),
            "small": rng.standard_normal((10, 10)).astype(np.float32)}


@pytest.mark.parametrize("ratio,min_size", [(0.01, 4096), (0.2, 64), (1e-9, 4096)])
def test_compression_is_jax_bit_for_bit(ratio, min_size):
    cfg = CompressionConfig(ratio=ratio, min_size=min_size)
    jcfg = JaxCompressionConfig(ratio=ratio, min_size=min_size)
    jstep = jax.jit(lambda g, r: jax_compress_and_correct(jcfg, g, r))
    tresid = compress_init(_t(_compress_tree(0)))
    jresid = jax.tree.map(lambda x: np.zeros_like(x), _compress_tree(0))
    for step in range(3):
        grads = _compress_tree(step)
        jwire, jresid = jstep(grads, jresid)
        twire, tresid = compress_and_correct(cfg, _t(grads), tresid)
        for got, want in zip(tree_leaves(twire), jax.tree.leaves(jwire)):
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
        for got, want in zip(tree_leaves(tresid), jax.tree.leaves(jresid)):
            np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                          np.asarray(want).view(np.uint32))
    if ratio < 1:
        sent = int((twire["big"] != 0).sum())
        assert sent >= max(1, int(80 * 64 * ratio))
