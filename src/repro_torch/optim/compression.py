"""Gradient compression with error feedback, after ``repro.optim.compression``.

Top-k magnitude sparsification per tensor with an error-feedback residual
(Stich et al. / Karimireddy et al.): the mass not sent is carried to the
next step.  The compressed tensor stays dense (masked, then cast to the
wire dtype), as in the JAX package, whose win is the all-reduce's bytes.
Tensors smaller than ``min_size`` (norms, biases) are sent dense, with the
cast error carried.

The threshold is the k-th largest ``|acc|`` (``torch.topk``'s last value,
the same element as ``jax.lax.top_k``'s), so the mask, the wire tensor and
the residual are the JAX package's bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.checkpoint import tree_leaves, tree_unflatten
from repro_torch.optim.adamw import tree_map


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    ratio: float = 0.01  # keep top 1% of entries
    min_size: int = 4096  # tensors smaller than this stay dense
    wire_dtype: str = "bfloat16"  # dtype of the masked all-reduce payload


def compress_init(params):
    """Error-feedback residual buffers (float32, zero)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def _topk_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    flat = torch.abs(x.reshape(-1))
    thresh = torch.topk(flat, k).values[-1]
    return (torch.abs(x) >= thresh).to(x.dtype)


@torch.no_grad()
def compress_and_correct(cfg: CompressionConfig, grads, residuals):
    """Sparsify ``grads + residuals``; returns (wire_grads, new_residuals).

    ``wire_grads`` is what would enter the data-parallel all-reduce (masked,
    cast to ``wire_dtype``); ``new_residuals`` holds the feedback error in
    float32."""
    wire_dtype = getattr(torch, cfg.wire_dtype)

    def one(g, r):
        acc = g.to(torch.float32) + r
        if acc.numel() < cfg.min_size:
            sent = acc.to(wire_dtype)
            # The wire cast drops mass too: carry its error.
            return sent, acc - sent.to(torch.float32)
        k = max(1, int(acc.numel() * cfg.ratio))
        sent = (acc * _topk_mask(acc, k)).to(wire_dtype)
        return sent, acc - sent.to(torch.float32)

    pairs = [one(g, r) for g, r in zip(tree_leaves(grads), tree_leaves(residuals))]
    return (tree_unflatten(grads, [p[0] for p in pairs]),
            tree_unflatten(grads, [p[1] for p in pairs]))
