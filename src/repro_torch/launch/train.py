"""Fault-tolerant trainer, after ``repro.launch.train``.

  * **exact resume**: the checkpoint manifest carries the step, the data
    stream's position (the step integer, see ``data/synthetic.py``), the
    seed and the config; ``--resume`` reproduces the loss trajectory of an
    uninterrupted run bit for bit on the CPU.  On the card the embedding's
    backward (``index_add_``) and the loss's gather backward add with
    atomics, whose order decides the last bits: a caller that wants the
    resume bit for bit there runs ``run`` under
    ``torch.use_deterministic_algorithms(True)``, with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before the process's first
    product.
  * **atomic + async checkpoints**: ``CheckpointManager`` (tmp + rename,
    daemon writer, retention), every ``ckpt_every`` steps and at the end.
  * **heartbeat**: one JSON line per step to ``<ckpt>/heartbeat.json``
    (step, loss, step time, wall time) for an external supervisor.
  * **straggler detection**: steps slower than ``straggler_factor`` times
    the rolling median step time are logged.
  * **restore onto the template's devices**: ``--resume`` puts every leaf
    on the device of the run's own state (the JAX package re-meshes).

``--smoke`` trains the arch's smoke config in float32 without recompute;
otherwise the published config runs as the JAX package runs it: bf16
compute over float32 master parameters and moments, each layer recomputed
in the backward.  A step is ``loss_fn``'s forward and backward, the
optional top-k compression, and ``adamw_update``; it launches no
hand-written kernel.  The device defaults to ``cuda`` and raises without a
card unless ``--device cpu`` is given.  Model parallelism
(``--model-axis > 1``) waits for the sharding slice.

Usage::

    python -m repro_torch.launch.train --arch qwen3-0.6b --smoke --steps 5 --device cpu
    python -m repro_torch.launch.train --arch qwen3-0.6b --steps 6 --global-batch 8 --seq-len 2048
    python -m repro_torch.launch.train --arch qwen3-0.6b --smoke --steps 50 \\
        --ckpt-dir /tmp/run1 [--resume]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import time

import torch

from repro_torch import random as trandom
from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager, latest_step, restore_checkpoint
from repro_torch.configs import get_arch
from repro_torch.data import SyntheticLMStream
from repro_torch.models import init_params, loss_fn
from repro_torch.models.moe import SHARDED_ITEM
from repro_torch.optim import (
    AdamWConfig,
    CompressionConfig,
    adamw_init,
    adamw_update,
    compress_and_correct,
    compress_init,
    tree_map,
    value_and_grad,
)


@dataclasses.dataclass
class TrainRun:
    arch: str
    steps: int = 50
    global_batch: int = 8
    seq_len: int = 128
    smoke: bool = True
    ckpt_dir: str = ""
    ckpt_every: int = 20
    resume: bool = False
    seed: int = 0
    model_axis: int = 1
    straggler_factor: float = 3.0
    compress: bool = False  # top-k + error-feedback gradient compression
    device: str = "cuda"


def _heartbeat(path: str, record: dict):
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def make_step(cfg, opt_cfg: AdamWConfig, compress_cfg: CompressionConfig | None = None):
    """``step(state, batch) -> (state', metrics)``: the loss and its
    gradients, the optional compression (its wire tensor cast back to
    float32), then AdamW.  ``state`` is ``{"params", "opt"}`` and, with
    compression, ``"resid"``."""
    grad_fn = value_and_grad(lambda p, b: loss_fn(p, cfg, b))

    def step(state, batch):
        loss, grads = grad_fn(state["params"], batch)
        new_state = {}
        if compress_cfg is not None:
            grads, new_state["resid"] = compress_and_correct(compress_cfg, grads,
                                                             state["resid"])
            grads = tree_map(lambda g: g.to(torch.float32), grads)
        params, opt, metrics = adamw_update(opt_cfg, state["params"], grads, state["opt"])
        metrics["loss"] = loss
        new_state.update(params=params, opt=opt)
        return new_state, metrics

    return step


def _batch(stream: SyntheticLMStream, cfg, step: int, dev) -> dict:
    batch = stream.batch(step, device=dev)
    if cfg.embeds_input:  # modality stub: hash-embed the tokens on the fly
        emb = (batch["inputs"][..., None] % 61 - 30).to(torch.float32)
        emb = emb.expand(*batch["inputs"].shape, cfg.d_model) / 30.0
        batch["inputs"] = emb.to(cfg.dtype)
    return batch


def run(tr: TrainRun) -> dict:
    """Train ``tr.steps`` steps (from the last checkpoint with ``resume``).
    Returns the losses, the final loss, the steps run, each step's seconds
    (the batch, the step, and the wait for its loss) and the final state
    (``{"params", "opt"}``, and ``"resid"`` with compression)."""
    if tr.model_axis > 1:
        raise NotImplementedError(f"--model-axis {tr.model_axis}: model parallelism waits for "
                                  f"{SHARDED_ITEM}")
    dev = resolve_device(tr.device)
    arch = get_arch(tr.arch)
    cfg = arch.smoke if tr.smoke else arch.model
    cfg = dataclasses.replace(cfg, dtype=torch.float32, remat=False) if tr.smoke else cfg
    opt_cfg = AdamWConfig(total_steps=tr.steps, warmup_steps=max(1, tr.steps // 10))
    compress_cfg = CompressionConfig() if tr.compress else None
    step_fn = make_step(cfg, opt_cfg, compress_cfg)
    stream = SyntheticLMStream(cfg.vocab_size, tr.seq_len, tr.global_batch, seed=tr.seed)

    start_step = 0
    params = init_params(trandom.PRNGKey(tr.seed), cfg, device=dev)
    state = {"params": params, "opt": adamw_init(params, opt_cfg.moment_dtype)}
    if tr.compress:
        state["resid"] = compress_init(params)
    del params

    mgr = CheckpointManager(tr.ckpt_dir, keep=3) if tr.ckpt_dir else None
    if tr.resume and tr.ckpt_dir and latest_step(tr.ckpt_dir) is not None:
        state, manifest = restore_checkpoint(tr.ckpt_dir, template=state)
        start_step = int(manifest["extra"]["next_step"])
        print(f"resumed at step {start_step} from {tr.ckpt_dir}")

    extra = {"seed": tr.seed, "arch": tr.arch, "smoke": tr.smoke}
    hb_path = os.path.join(tr.ckpt_dir, "heartbeat.json") if tr.ckpt_dir else ""
    losses, step_times = [], []
    for s in range(start_step, tr.steps):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, _batch(stream, cfg, s, dev))
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        losses.append(loss)
        step_times.append(dt)

        if len(step_times) >= 5:  # straggler detection (rolling median)
            med = statistics.median(step_times[-20:])
            if dt > tr.straggler_factor * med:
                print(f"[straggler] step {s}: {dt*1e3:.0f}ms vs median {med*1e3:.0f}ms")
        if hb_path:
            _heartbeat(hb_path, {"step": s, "loss": loss, "step_time_s": dt,
                                 "time": time.time()})
        if mgr and (s + 1) % tr.ckpt_every == 0:
            mgr.save_async(s + 1, state, extra={"next_step": s + 1, **extra})
    if mgr:
        mgr.save(tr.steps, state, extra={"next_step": tr.steps, **extra})
        mgr.wait()
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "steps_run": len(losses), "step_seconds": step_times, "state": state}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    out = run(TrainRun(arch=a.arch, steps=a.steps, global_batch=a.global_batch,
                       seq_len=a.seq_len, smoke=a.smoke, ckpt_dir=a.ckpt_dir,
                       ckpt_every=a.ckpt_every, resume=a.resume, model_axis=a.model_axis,
                       compress=a.compress, device=a.device))
    if out["final_loss"] is None:
        print("nothing to do (checkpoint already at/after --steps); 0 steps run")
    else:
        print(f"final loss: {out['final_loss']:.4f} after {out['steps_run']} steps")


if __name__ == "__main__":
    main()
