"""Primitive layers, after ``repro.models.layers``: plain functions over
param dicts of tensors.

Params are nested dicts of float32 tensors (master copies), ``{"w": [d_in,
d_out]}`` for a linear layer so that ``x @ w`` is ``linear``; compute
happens in the model's activation dtype with float32 where the JAX package
keeps it (the norms' statistics, the attention scores, the softmax).  Every
initialiser draws through ``repro_torch.random`` from the key the JAX
package's would use, on ``device``: ``cuda`` unless the caller passes
``device="cpu"`` (``repro_torch.resolve_device``), as every entry of the
package that makes tensors.
"""

from __future__ import annotations

import torch

from repro_torch import random as trandom
from repro_torch import resolve_device


def _normal(key, shape, device) -> torch.Tensor:
    """``random.normal`` draws; on the ``meta`` device (``num_params``) the
    shape alone, with no draw."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=dev)
    return trandom.normal(key, shape, device=dev)


def init_linear(key, d_in: int, d_out: int, *, scale: float | None = None, device="cuda"):
    scale = scale if scale is not None else d_in**-0.5
    return {"w": _normal(key, (d_in, d_out), device) * scale}


def linear(p, x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(dtype) @ p["w"].to(dtype)


def init_rmsnorm(d: int, device="cuda"):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=resolve_device(device))}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with the statistics in float32: ``x·rsqrt(mean(x²) + eps)·scale``
    in the JAX package's order."""
    dt = x.dtype
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(dt)


def init_embedding(key, vocab: int, d: int, device="cuda"):
    return {"table": _normal(key, (vocab, d), device) * (d**-0.5)}


def embed(p, ids: torch.Tensor, dtype) -> torch.Tensor:
    """``take(table.astype(dtype), ids, axis=0)``; the rows are gathered
    first and then cast, the same values without a copy of the table."""
    table = p["table"]
    return table.index_select(0, ids.reshape(-1)).reshape(ids.shape + table.shape[1:]).to(dtype)


def rope_frequencies(head_dim: int, theta: float, device="cuda") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=resolve_device(device)) / head_dim
    return 1.0 / (torch.full_like(exps, theta) ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: ``(..., seq, heads, head_dim)``; positions: ``(..., seq)`` int.  The
    rotation pairs the two HALVES of the head (``x1 = x[..., :hd/2]`` with
    ``x2 = x[..., hd/2:]``), as the JAX package splits them, not
    interleaved pairs."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)  # (hd/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs  # (..., s, hd/2)
    cos = torch.cos(angles)[..., :, None, :]  # (..., s, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
