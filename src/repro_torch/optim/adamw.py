"""AdamW + cosine schedule + global-norm clipping over trees of tensors,
after ``repro.optim.adamw``.

State layout::

    state = {"step": int32[], "mu": tree_like(params), "nu": tree_like(params)}

A tree is nested dicts and lists of tensors, the model's parameter tree.
The arithmetic is the JAX package's, in its order (``adamw_update``), not
``torch.optim.AdamW``'s, which decays the weights as ``p·(1 - lr·wd)``
before the step and so gives other numbers.  The step count, the learning
rate and the bias corrections stay 0-d tensors on the parameters' device,
so a step never waits on the card.  ZeRO-1's ``opt_state_pspecs`` comes with
the sharding slice (ROADMAP Queue A item A11f).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.checkpoint import tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    end_lr: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 1000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0  # 0 disables
    moment_dtype: str = "float32"


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def _f32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.tensor(float(x), dtype=torch.float32, device=device)


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``end_lr``, in float32 (a 0-d tensor
    on ``step``'s device; an int step gives a CPU tensor)."""
    step = _f32(step)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.end_lr + 0.5 * (cfg.peak_lr - cfg.end_lr) * (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """``sqrt(Σ_leaf Σ x²)`` in float32: a sum per leaf, then the sum of
    those (the JAX package's grouping; each sum's own order of adds is the
    library's)."""
    sums = [torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads, max_norm: float):
    """Returns (clipped_grads, pre_clip_norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def adamw_init(params, moment_dtype=torch.float32):
    """Zero moments in ``moment_dtype`` (a torch dtype or its name) beside
    each parameter, and a step count of 0 on the parameters' device."""
    if isinstance(moment_dtype, str):
        moment_dtype = getattr(torch, moment_dtype)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None

    def zeros(p):
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)

    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state):
    """One AdamW step.  Returns (params', state', metrics dict).

    Decoupled weight decay is applied to every >=2-D tensor (matrices,
    embeddings) and skipped for 1-D tensors (norms, biases, SSM vectors).
    Per leaf, in float32: ``mu = b1·mu + (1-b1)·g``, ``nu = b2·nu +
    (1-b2)·g²``, ``u = (mu/c1) / (sqrt(nu/c2) + eps)`` with ``c = 1 -
    b**step``, ``u += wd·p``, ``p -= lr·u``, cast back to the parameter's
    dtype; the moments are stored in their own dtype."""
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    if cfg.clip_norm > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = global_norm(grads)

    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    c1 = 1.0 - b1 ** stepf
    c2 = 1.0 - b2 ** stepf

    def upd(p, g, mu, nu):
        mdt = mu.dtype
        g32 = g.to(torch.float32)
        mu = b1 * mu.to(torch.float32) + (1 - b1) * g32
        nu = b2 * nu.to(torch.float32) + (1 - b2) * torch.square(g32)
        stepv = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
        if cfg.weight_decay > 0 and p.ndim >= 2:
            stepv = stepv + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * stepv).to(p.dtype), mu.to(mdt), nu.to(mdt)

    out = [upd(p, g, m, n) for p, g, m, n in zip(tree_leaves(params), tree_leaves(grads),
                                                   tree_leaves(state["mu"]),
                                                   tree_leaves(state["nu"]))]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_mu = tree_unflatten(params, [o[1] for o in out])
    new_nu = tree_unflatten(params, [o[2] for o in out])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, {"step": step, "mu": new_mu, "nu": new_nu}, metrics
