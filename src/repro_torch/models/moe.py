"""Mixture-of-Experts, after ``repro.models.moe``: sort-based top-k dispatch
(MegaBlocks-lite).

  1. router logits -> top-k (expert, gate) per token;
  2. flatten the (T·k) assignments, sort them by expert id (stably);
  3. position within the expert from exclusive counts; drop beyond the
     capacity ``C = ceil(T·k / E)·capacity_factor`` (token dropping; a
     decode-sized batch, T <= 256, dispatches dropless);
  4. scatter the tokens into an (E, C, D) buffer, run both MLP products as
     batched ``(E,C,D) x (E,D,F)`` matmuls, gather back weighted by the
     gate.

DBRX (16 experts top-4) and Llama4-Maverick (128 top-1 + a shared expert)
both route through here.  The combine adds each token's k contributions in
one fixed order, ascending expert id, which is the order in which the JAX
package's ``.at[tok_sorted].add`` meets them on the CPU; no float atomic
add (``index_add_`` on the card) decides the bits.  Expert parallelism
(``moe_sharded``) waits for the sharding slice (ROADMAP Queue A item A11f).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import random as trandom
from repro_torch.models.layers import _normal, init_linear, linear
from repro_torch.models.mlp import init_mlp, mlp

#: Where expert parallelism is queued (ROADMAP Queue A).
SHARDED_ITEM = "ROADMAP Queue A item A11f (models/partitioning.py, launch/sharding.py)"
#: Largest token count that dispatches without dropping (decode batches).
DROPLESS_TOKENS = 256


def init_moe(key, cfg, device="cuda"):
    """The JAX package's ``init_moe`` on the same keys: ``split(key, 4)``,
    the shared expert from ``fold_in(key, 7)``."""
    ks = trandom.split(key, 4)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {
        "router": init_linear(ks[0], d, e, device=device),
        "w1": {"w": _normal(ks[1], (e, d, f), device) * (d**-0.5)},
        "w3": {"w": _normal(ks[3], (e, d, f), device) * (d**-0.5)},
        "w2": {"w": _normal(ks[2], (e, f, d), device) * (f**-0.5)},
    }
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(trandom.fold_in(key, 7), d, cfg.d_ff * cfg.num_shared_experts,
                               cfg.mlp_type, device)
    return p


def capacity(t: int, cfg, capacity_factor: float = 1.25) -> int:
    """Slots an expert takes: every assignment at ``t <= 256`` tokens, else
    ``int(max(1, ceil(t·k / E))·capacity_factor)`` in Python floats, as the
    JAX package computes it."""
    e, k = cfg.num_experts, cfg.top_k
    if t <= DROPLESS_TOKENS:
        return t * k
    return int(max(1, (t * k + e - 1) // e) * capacity_factor)


def route(p, cfg, x2: torch.Tensor):
    """Router of tokens ``x2 (T, D)``: ``(gates (T, k) in x2's dtype, expert
    ids int64 (T, k))``, the k largest logits in descending order, ties to
    the lower index (``jax.lax.top_k``: a stable sort), gates their
    softmax."""
    logits = linear(p["router"], x2, torch.float32)  # (T, E) in f32
    vals, eids = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(vals[:, :cfg.top_k], dim=-1).to(x2.dtype)
    return gates, eids[:, :cfg.top_k]


def dispatch(cfg, eids: torch.Tensor, cap: int):
    """The assignments in expert order: ``(order, e_sorted, pos, keep)``,
    ``order`` the stable argsort of the flat expert ids (``jnp.argsort``),
    ``pos`` each assignment's slot in its expert, ``keep`` the slots under
    ``cap``."""
    flat_e = eids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    counts = torch.bincount(flat_e, minlength=cfg.num_experts)
    starts = torch.cumsum(counts, 0) - counts  # exclusive prefix
    pos = torch.arange(flat_e.numel(), device=eids.device) - starts[e_sorted]
    return order, e_sorted, pos, pos < cap


def moe(p, cfg, x, *, capacity_factor: float = 1.25):
    """x: (B, S, D) -> (B, S, D).  Token-dropping top-k routing on one
    device (``moe_sharded`` waits for ``SHARDED_ITEM``)."""
    return _moe_local(p, cfg, x, capacity_factor=capacity_factor)


def _moe_local(p, cfg, x, *, capacity_factor: float = 1.25):
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.top_k
    x2 = x.reshape(t, d)
    gates, eids = route(p, cfg, x2)
    cap = capacity(t, cfg, capacity_factor)
    order, e_sorted, pos, keep = dispatch(cfg, eids, cap)
    tok_sorted = order // k  # assignment a is token a // k's
    gate_sorted = gates.reshape(-1)[order]

    # scatter into (E, C, D): each kept (expert, slot) is one assignment's
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
    buf[e_sorted[keep], pos[keep]] = x2[tok_sorted[keep]]

    # grouped products
    h = torch.bmm(buf, p["w1"]["w"].to(x.dtype))
    g = torch.bmm(buf, p["w3"]["w"].to(x.dtype))
    y = torch.bmm(F.silu(g) * h, p["w2"]["w"].to(x.dtype))

    # gather back, weighted by the gate (0 where dropped)
    safe_pos = torch.where(keep, pos, torch.zeros_like(pos))
    y_tok = y[e_sorted, safe_pos] * torch.where(keep, gate_sorted,
                                                torch.zeros_like(gate_sorted))[:, None]
    # each token's k contributions, added in ascending expert order
    y_asg = torch.empty_like(y_tok)
    y_asg[order] = y_tok  # back in (token, rank) order
    y_asg = y_asg.reshape(t, k, d)
    by_expert = torch.argsort(eids, dim=-1, stable=True)
    out = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        idx = by_expert[:, j, None, None].expand(t, 1, d)
        out = out + torch.gather(y_asg, 1, idx)[:, 0]

    if cfg.num_shared_experts:
        out = out + mlp(p["shared"], x2, cfg.mlp_type)
    return out.reshape(b, s, d)


def moe_sharded(p, cfg, x, *, capacity_factor: float = 1.25):
    """Expert-parallel dispatch over a device mesh: not ported yet."""
    raise NotImplementedError(f"moe_sharded: expert parallelism waits for {SHARDED_ITEM}")


def aux_load_balance_loss(p, cfg, x):
    """Switch-style auxiliary loss ``E·Σ f_i·P_i`` (optional in training)."""
    d = x.shape[-1]
    logits = linear(p["router"], x.reshape(-1, d), torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top1 = torch.argmax(logits, dim=-1)
    f = torch.bincount(top1, minlength=cfg.num_experts) / logits.shape[0]
    return cfg.num_experts * torch.sum(f * torch.mean(probs, dim=0))
