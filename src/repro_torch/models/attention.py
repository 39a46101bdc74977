"""GQA attention, after ``repro.models.attention``: training/prefill
(q-chunked, exact) and cached decode.

RoPE, qk-norm (Qwen3/Chameleon), sliding windows (Gemma3 local layers,
H2O-Danube, Llama4 chunked-local) and grouped KV heads.  Prefill chunks
over the queries (an exact softmax per chunk); sliding-window layers are
banded, each chunk seeing only the keys its window reaches.

GQA: the JAX package expands the KV heads with ``jnp.repeat(k, g, axis=2)``,
so query head ``i`` reads KV head ``i // g`` (``torch.repeat_interleave``'s
order, not ``tile``'s).  The port keeps that map without the copy: the
query heads are viewed as ``(Hkv, g)`` and each group contracts with its
KV head, the same products and the same sums over ``head_dim``.
"""

from __future__ import annotations

import torch

from repro_torch import random as trandom
from repro_torch.models.layers import apply_rope, init_linear, init_rmsnorm, linear, rmsnorm

NEG_INF = -1e30


def init_attention(key, cfg, device="cuda"):
    ks = trandom.split(key, 6)
    hd = cfg.head_dim
    p = {
        "wq": init_linear(ks[0], cfg.d_model, cfg.num_heads * hd, device=device),
        "wk": init_linear(ks[1], cfg.d_model, cfg.num_kv_heads * hd, device=device),
        "wv": init_linear(ks[2], cfg.d_model, cfg.num_kv_heads * hd, device=device),
        "wo": init_linear(ks[3], cfg.num_heads * hd, cfg.d_model, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, device)
        p["k_norm"] = init_rmsnorm(hd, device)
    return p


def _project_qkv(p, cfg, x, positions):
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = linear(p["wq"], x, x.dtype).reshape(b, s, cfg.num_heads, hd)
    k = linear(p["wk"], x, x.dtype).reshape(b, s, cfg.num_kv_heads, hd)
    v = linear(p["wv"], x, x.dtype).reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _scores_mask(q_pos, k_pos, window: int) -> torch.Tensor:
    """(q, k) additive float32 mask: causal and an optional sliding window."""
    causal = q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        causal &= (q_pos[:, None] - k_pos[None, :]) < window
    zero = torch.zeros((), dtype=torch.float32, device=causal.device)
    return torch.where(causal, zero, torch.full_like(zero, NEG_INF))


def _sdpa(q, k, v, mask, dtype):
    """q (b,qs,Hq,hd), k/v (b,ks,Hkv,hd), mask (qs,ks) additive f32; the
    scores and the softmax in float32, the weighted sum in ``dtype``."""
    b, qs, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, qs, hkv, g, hd)  # query head h·g + j reads KV head h
    scores = torch.einsum("bqhgd,bshd->bhgqs", qg.to(torch.float32), k.to(torch.float32))
    scores = scores * (hd**-0.5) + mask
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqs,bshd->bqhgd", probs.to(dtype), v)
    return out.reshape(b, qs, hq * hd)


def attention(p, cfg, x, positions, *, window: int = 0, q_chunk: int = 4096):
    """Exact causal (optionally windowed) attention; returns (out, (k, v)).

    Sliding-window layers are banded: each q chunk sees only the k range
    ``[chunk_lo - window + 1, chunk_hi)``; the chunk is at least 4096 (or
    the window), as in the JAX package."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    k_pos = positions[0] if positions.ndim == 2 else positions  # (s,)

    if window > 0:
        q_chunk = min(q_chunk, max(window, 4096))
    chunks = []
    n_chunks = max(1, (s + q_chunk - 1) // q_chunk)
    for ci in range(n_chunks):
        lo = ci * q_chunk
        hi = min(s, lo + q_chunk)
        klo = max(0, lo - window + 1) if window > 0 else 0
        mask = _scores_mask(k_pos[lo:hi], k_pos[klo:hi], window)
        chunks.append(_sdpa(q[:, lo:hi], k[:, klo:hi], v[:, klo:hi], mask, x.dtype))
    out = torch.cat(chunks, dim=1) if len(chunks) > 1 else chunks[0]
    return linear(p["wo"], out, x.dtype), (k, v)


def decode_attention(p, cfg, x, cache_kv, pos: int, *, window: int = 0):
    """One-token decode: x (b,1,D), ring cache k/v (b,L,Hkv,hd), ``pos`` the
    current position (an int).

    The cache is a ring of length ``L``: position ``p`` lives in slot
    ``p % L`` (for full-attention layers L = max_seq, so the ring is the
    plain cache; for sliding-window layers L = window).  Slot ``j`` holds
    absolute position ``pos - ((pos - j) mod L)``, masked when negative or
    outside the window.  The new K/V are written into the given cache
    tensors in place (the JAX function returns updated copies; a decode
    step of the full model would otherwise copy every cache leaf).
    Returns (out (b,1,D), the cache)."""
    pos = int(pos)
    b = x.shape[0]
    k_cache, v_cache = cache_kv
    ring = k_cache.shape[1]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    slot = pos % ring
    k_cache[:, slot] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v_new[:, 0].to(v_cache.dtype)

    j = torch.arange(ring, dtype=torch.int32, device=x.device)
    k_pos = pos - torch.remainder(pos - j, ring)  # absolute position held by slot j
    valid = k_pos >= 0
    if window > 0:
        valid &= (pos - k_pos) < window
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    mask = torch.where(valid, zero, torch.full_like(zero, NEG_INF))[None, :]  # (1, L)
    out = _sdpa(q, k_cache.to(x.dtype), v_cache.to(x.dtype), mask, x.dtype)
    return linear(p["wo"], out, x.dtype), (k_cache, v_cache)
