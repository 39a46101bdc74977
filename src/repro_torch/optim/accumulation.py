"""Loss and gradients over a tree of parameters, whole or over microbatches,
after ``repro.optim.accumulation`` (and ``jax.value_and_grad``).

The JAX package scans one loss/grad body over the microbatch axis; here a
Python loop runs the microbatches one after another, so peak activation
memory is one microbatch's as there.  Gradients are accumulated in float32
from zeros, in microbatch order, then scaled by ``1/n``.
"""

from __future__ import annotations

import torch

from repro_torch.checkpoint import tree_leaves, tree_unflatten
from repro_torch.optim.adamw import tree_map


def value_and_grad(loss_fn):
    """``jax.value_and_grad``'s counterpart for a loss of a parameter tree:
    ``value_and_grad(loss_fn)(params, *args) -> (loss, grads)``, ``grads``
    shaped as ``params`` (zeros for a leaf the loss does not use).  The
    leaves are taken as detached views, so the caller's tensors gain no
    ``requires_grad`` and no ``.grad``."""
    def run(params, *args):
        live = [leaf.detach().requires_grad_(True) for leaf in tree_leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(tree_unflatten(params, live), *args)
            grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
        return loss.detach(), tree_unflatten(params, list(grads))
    return run


def microbatch_grads(loss_fn, params, batch, num_microbatches: int):
    """Mean loss/grads of ``loss_fn(params, micro_batch)`` over microbatches.

    ``batch`` leaves are split on axis 0 into ``num_microbatches`` equal
    slices.  With ``num_microbatches <= 1`` it is exactly the full-batch
    ``value_and_grad``."""
    grad_fn = value_and_grad(loss_fn)
    if num_microbatches <= 1:
        return grad_fn(params, batch)

    def split(x):
        b = x.shape[0]
        assert b % num_microbatches == 0, (b, num_microbatches)
        return x.reshape(num_microbatches, b // num_microbatches, *x.shape[1:])

    micro = tree_map(split, batch)
    leaves = tree_leaves(params)
    loss_acc = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    grads_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                         params)
    for i in range(num_microbatches):
        loss, grads = grad_fn(params, tree_map(lambda x: x[i], micro))
        grads_acc = tree_map(lambda a, g: a + g.to(a.dtype), grads_acc, grads)
        loss_acc = loss_acc + loss
    inv = 1.0 / num_microbatches
    return loss_acc * inv, tree_map(lambda g: g * inv, grads_acc)
