"""The port's trainer (``repro_torch.launch.train``) on the CPU.

* An 8-step ``run`` of the qwen3 smoke config (float32, global batch 4 of
  32 tokens) against a loop composed of the JAX package's green parts under
  ``jax.jit`` (``loss_fn`` under ``jax.value_and_grad``, ``adamw_update``,
  ``SyntheticLMStream``, and ``compress_and_correct`` in the compressed
  run), from the same initial parameters: every loss within
  ``TRAJ_RTOL`` (1e-5; measured: within 1.5e-7) and the final parameters
  within ``PARAM_ATOL`` (2e-5; measured: within 2e-6).  The JAX package's
  own ``run`` cannot be the reference: it raises under its sharding rules
  (ROADMAP Queue C item 6).
* The port alone: a run of 8 steps killed after its checkpoint at step 4,
  then resumed (``--resume``), reproduces the uninterrupted 8 bit for bit,
  the losses and the final state; the heartbeat is written; the loss decreases over 20 steps of the
  mamba2 smoke config; the hash-embedded inputs of an ``embeds_input``
  arch train; ``--model-axis 2`` raises naming its ROADMAP item; ``cuda``
  raises without a card.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_arch as jax_arch
from repro.data import SyntheticLMStream as JaxStream
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim.compression import CompressionConfig as JaxCompressionConfig
from repro.optim.compression import compress_and_correct as jax_compress_and_correct
from repro.optim.compression import compress_init as jax_compress_init
from repro_torch import convert
from repro_torch import models as tm
from repro_torch import random as trandom
from repro_torch.checkpoint import tree_leaves
from repro_torch.configs import get_arch
from repro_torch.launch import train
from repro_torch.launch.train import TrainRun, run

TRAJ_RTOL = 1e-5
PARAM_ATOL = 2e-5
BASE = dict(arch="qwen3-0.6b", smoke=True, global_batch=4, seq_len=32, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: under the suite's parallel workers, OpenMP's
    spinning threads of every worker's small ops contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_trajectory(steps: int, compress: bool):
    """The composed JAX loop from the port's initial parameters (``run``
    draws them from ``PRNGKey(seed)``, seed 0): (losses, final params)."""
    jcfg = dataclasses.replace(jax_arch("qwen3-0.6b").smoke, dtype=jnp.float32, remat=False)
    tcfg = dataclasses.replace(get_arch("qwen3-0.6b").smoke, dtype=torch.float32, remat=False)
    params = jax.tree.map(jnp.asarray, convert.params_to_jax(
        tm.init_params(trandom.PRNGKey(0), tcfg, device="cpu")))
    opt = JaxAdamWConfig(total_steps=steps, warmup_steps=max(1, steps // 10))
    state = {"params": params, "opt": jax_adamw_init(params)}
    if compress:
        state["resid"] = jax_compress_init(params)

    @jax.jit
    def step(state, batch):
        loss, grads = jax.value_and_grad(lambda p: jm.loss_fn(p, jcfg, batch))(state["params"])
        new = {}
        if compress:
            grads, new["resid"] = jax_compress_and_correct(JaxCompressionConfig(), grads,
                                                           state["resid"])
            grads = jax.tree.map(lambda g: g.astype(jnp.float32), grads)
        new["params"], new["opt"], _ = jax_adamw_update(opt, state["params"], grads,
                                                        state["opt"])
        return new, loss

    stream = JaxStream(jcfg.vocab_size, BASE["seq_len"], BASE["global_batch"], seed=0)
    losses = []
    for s in range(steps):
        state, loss = step(state, stream.batch(s))
        losses.append(float(loss))
    return losses, jax.tree.leaves(state["params"])


@pytest.mark.parametrize("compress", [False, True])
def test_trajectory_is_the_composed_jax_loop(compress):
    out = run(TrainRun(steps=8, compress=compress, **BASE))
    want_losses, want_params = _jax_trajectory(8, compress)
    np.testing.assert_allclose(out["losses"], want_losses, rtol=TRAJ_RTOL)
    got_params = tree_leaves(out["state"]["params"])
    assert len(got_params) == len(want_params)
    for got, want in zip(got_params, want_params):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=PARAM_ATOL)
    assert out["steps_run"] == 8 and len(out["step_seconds"]) == 8


class Killed(Exception):
    """The process dying right after a checkpoint is on disk."""


def kill_after_first_save(monkeypatch):
    save_async = train.CheckpointManager.save_async

    def save_then_die(self, step, tree, *, extra=None):
        save_async(self, step, tree, extra=extra)
        self.wait()
        raise Killed(step)

    monkeypatch.setattr(train.CheckpointManager, "save_async", save_then_die)


def test_resume_reproduces_uninterrupted_run_bit_for_bit(tmp_path, monkeypatch):
    """8 steps straight against a run of 8 killed after its checkpoint at
    step 4, then ``resume``: the same losses (the killed run's from its
    heartbeat) and the same final state, bit for bit."""
    full = run(TrainRun(steps=8, ckpt_dir=str(tmp_path / "a"), ckpt_every=100, **BASE))
    rdir = tmp_path / "b"
    with monkeypatch.context() as m:
        kill_after_first_save(m)
        with pytest.raises(Killed):
            run(TrainRun(steps=8, ckpt_dir=str(rdir), ckpt_every=4, **BASE))
    first = [json.loads(line)["loss"] for line in open(rdir / "heartbeat.json")]
    second = run(TrainRun(steps=8, ckpt_dir=str(rdir), ckpt_every=100, resume=True, **BASE))
    assert len(first) == 4 and second["steps_run"] == 4
    assert first + second["losses"] == full["losses"]
    for got, want in zip(tree_leaves(second["state"]), tree_leaves(full["state"])):
        assert got.dtype == want.dtype and torch.equal(got, want)
    # a resume at the end has nothing left to do
    again = run(TrainRun(steps=8, ckpt_dir=str(rdir), resume=True, **BASE))
    assert again["steps_run"] == 0 and again["final_loss"] is None


def test_heartbeat_written(tmp_path):
    run(TrainRun(steps=3, ckpt_dir=str(tmp_path), **BASE))
    hb = [json.loads(line) for line in open(tmp_path / "heartbeat.json")]
    assert [r["step"] for r in hb] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) and r["step_time_s"] > 0 for r in hb)


def test_loss_decreases():
    out = run(TrainRun(arch="mamba2-1.3b", steps=20, smoke=True, global_batch=8, seq_len=32,
                       device="cpu"))
    assert all(np.isfinite(out["losses"]))
    assert out["losses"][-1] < out["losses"][0]


def test_embeds_input_arch_trains_on_hash_embeddings():
    """musicgen takes frame embeddings: the hash-embed stub of the tokens."""
    cfg = get_arch("musicgen-large").smoke
    assert cfg.embeds_input
    out = run(TrainRun(arch="musicgen-large", steps=2, smoke=True, global_batch=2, seq_len=16,
                       device="cpu"))
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert "embed" not in out["state"]["params"]


def test_main_prints_the_final_loss(capsys):
    train.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "2", "--global-batch", "2",
                "--seq-len", "16", "--device", "cpu"])
    assert "final loss:" in capsys.readouterr().out


def test_model_axis_raises_naming_its_item():
    with pytest.raises(NotImplementedError, match="A11f"):
        run(TrainRun(steps=1, model_axis=2, **BASE))


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_cuda_device_raises_without_a_card():
    with pytest.raises(RuntimeError, match="device='cuda'"):
        run(TrainRun(**dict(BASE, device="cuda"), steps=1))
