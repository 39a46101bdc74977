"""Feed-forward variants, after ``repro.models.mlp``: SwiGLU (llama/qwen/dbrx),
GeGLU (gemma), squared-ReLU (nemotron), GELU (musicgen/chameleon-style).

``jax.nn.gelu`` defaults to the tanh approximation, so the port's GELU is
``gelu(x, approximate="tanh")``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import random as trandom
from repro_torch.models.layers import init_linear, linear

GATED = {"swiglu", "geglu"}
MLP_TYPES = ("swiglu", "geglu", "squared_relu", "gelu")


def init_mlp(key, d_model: int, d_ff: int, mlp_type: str, device="cuda"):
    ks = trandom.split(key, 3)
    p = {
        "w_in": init_linear(ks[0], d_model, d_ff, device=device),
        "w_out": init_linear(ks[1], d_ff, d_model, device=device),
    }
    if mlp_type in GATED:
        p["w_gate"] = init_linear(ks[2], d_model, d_ff, device=device)
    return p


def mlp(p, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    h = linear(p["w_in"], x, x.dtype)
    if mlp_type == "swiglu":
        h = F.silu(linear(p["w_gate"], x, x.dtype)) * h
    elif mlp_type == "geglu":
        h = F.gelu(linear(p["w_gate"], x, x.dtype), approximate="tanh") * h
    elif mlp_type == "squared_relu":
        r = F.relu(h)
        h = r * r
    elif mlp_type == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(f"unknown mlp_type {mlp_type}")
    return linear(p["w_out"], h, x.dtype)
