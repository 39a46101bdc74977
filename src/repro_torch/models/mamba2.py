"""Mamba2 / SSD (state-space duality) block, after ``repro.models.mamba2``:
chunked prefill and recurrent decode.

The ``ssd_minimal`` formulation of the Mamba2 paper (arXiv:2405.21060):
intra-chunk quadratic attention-like einsums plus an inter-chunk state
recurrence.  The JAX package runs the recurrence as ``lax.associative_scan``
(log depth); here it is a loop over the chunks, ``H_{c+1} = H_c·exp(Σa_c) +
states_c``, the same terms added in another order (the tests state the
bound).

Block layout (one state group), with separate input projections:

    z  = x W_z   (d_inner, gate)        x_in = x W_x  (d_inner)
    B  = x W_b   (N)                    C    = x W_c  (N)
    dt = x W_dt  (heads)
    causal depthwise conv (width 4) on x_in / B / C separately
    SSD over heads with per-head decay A; gated RMSNorm; out_proj

The decode state is ``(heads, head_dim, N)`` float32 a sequence a layer,
whatever the context length, beside three conv windows of ``CONV_WIDTH - 1``
positions.  ``mamba_decode_step`` updates the SSM state in place, as
``attention.decode_attention`` writes its K/V into the caches it is given.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import random as trandom
from repro_torch import resolve_device
from repro_torch.models.layers import _normal, init_linear, init_rmsnorm, linear, rmsnorm

CONV_WIDTH = 4


def mamba_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = d_inner // cfg.ssm_head_dim
    return d_inner, heads, cfg.ssm_state


def _linspace_f32(start: float, stop: float, num: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, num, dtype=float32)`` in its own float32
    arithmetic: ``start·(1 - i/div) + stop·(i/div)`` with the endpoint set
    (``torch.linspace`` steps from the start instead, and rounds otherwise)."""
    div = num - 1
    if div < 1:
        return torch.full((num,), start, dtype=torch.float32)
    lo = torch.tensor(start, dtype=torch.float32)
    hi = torch.tensor(stop, dtype=torch.float32)
    step = torch.arange(div, dtype=torch.float32) / torch.tensor(float(div))
    out = lo * (1 - step) + hi * step
    return torch.cat([out, hi.reshape(1)])


def init_mamba(key, cfg, device="cuda"):
    """The JAX package's ``init_mamba`` on the same keys (``split(key,
    10)``), float32 leaves on ``device`` (``meta`` for shapes only)."""
    dev = torch.device(device) if str(device) == "meta" else resolve_device(device)
    d = cfg.d_model
    d_inner, heads, n = mamba_dims(cfg)
    ks = trandom.split(key, 10)

    def conv(k, width):
        return {"w": _normal(k, (CONV_WIDTH, width), dev) * 0.2,
                "b": torch.zeros((width,), dtype=torch.float32, device=dev)}

    return {
        "in_z": init_linear(ks[0], d, d_inner, device=dev),
        "in_x": init_linear(ks[1], d, d_inner, device=dev),
        "in_b": init_linear(ks[2], d, n, device=dev),
        "in_c": init_linear(ks[3], d, n, device=dev),
        "in_dt": init_linear(ks[4], d, heads, device=dev),
        "conv_x": conv(ks[5], d_inner),
        "conv_b": conv(ks[6], n),
        "conv_c": conv(ks[7], n),
        "a_log": torch.log(_linspace_f32(1.0, float(heads), heads)).to(dev),
        "d_skip": torch.ones((heads,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((heads,), dtype=torch.float32, device=dev),
        "norm": init_rmsnorm(d_inner, dev),
        "out_proj": init_linear(ks[8], d_inner, d, device=dev),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``
    at every x (``F.softplus`` returns x itself above its threshold)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """``(..., l) -> (..., l, l)`` lower-triangular cumulative segment sums;
    ``-inf`` above the diagonal, which ``exp`` turns into exact zeros."""
    sl = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((sl, sl), dtype=torch.bool, device=x.device))
    return torch.where(mask, d, torch.tensor(float("-inf"), dtype=d.dtype, device=d.device))


def _ssd_chunked(x, log_da, b_ssm, c_ssm, chunk: int):
    """x (b,s,h,p) pre-scaled by dt; log_da (b,s,h); b/c (b,s,n).
    Returns y (b,s,h,p) f32 and final state (b,h,p,n) f32."""
    bsz, s, h, p = x.shape
    n = b_ssm.shape[-1]
    if s % chunk:
        raise ValueError(f"_ssd_chunked: sequence {s} is not a multiple of chunk {chunk}")
    c = s // chunk
    xc = x.reshape(bsz, c, chunk, h, p)
    ac = log_da.reshape(bsz, c, chunk, h).permute(0, 3, 1, 2)  # (b,h,c,l)
    bc = b_ssm.reshape(bsz, c, chunk, n)
    cc = c_ssm.reshape(bsz, c, chunk, n)

    a_cum = torch.cumsum(ac, dim=-1)  # (b,h,c,l)

    # 1. intra-chunk (diagonal blocks)
    decay = torch.exp(_segsum(ac))  # (b,h,c,l,l)
    y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", cc, bc, decay, xc)

    # 2. per-chunk input -> end-of-chunk state
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # (b,h,c,l)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", bc, decay_states, xc)

    # 3. inter-chunk recurrence H_{c+1} = H_c * exp(sum a_c) + states_c, in
    #    chunk order (the JAX package's associative scan adds in a tree)
    chunk_decay = torch.exp(a_cum[..., -1]).permute(0, 2, 1)  # (b,c,h)
    scan = [states[:, 0]]
    for ci in range(1, c):
        scan.append(scan[-1] * chunk_decay[:, ci, :, None, None] + states[:, ci])
    final_state = scan[-1]  # (b,h,p,n)
    h_prev = torch.stack([torch.zeros_like(scan[0])] + scan[:-1], dim=1)

    # 4. carried state -> output contribution
    state_decay_out = torch.exp(a_cum)  # (b,h,c,l)
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", cc, h_prev, state_decay_out)

    return (y_diag + y_off).reshape(bsz, s, h, p), final_state


def _causal_conv(seq: torch.Tensor, conv_p) -> torch.Tensor:
    """Depthwise causal conv, width ``CONV_WIDTH``, then SiLU.  seq (b,s,c);
    the taps are added in the JAX package's order."""
    w, b = conv_p["w"], conv_p["b"]
    s = seq.shape[1]
    pad = F.pad(seq, (0, 0, CONV_WIDTH - 1, 0))
    out = 0
    for i in range(CONV_WIDTH):
        out = out + pad[:, i:i + s] * w[i][None, None, :].to(seq.dtype)
    return F.silu(out + b.to(seq.dtype))


def mamba_block(p, cfg, x, *, chunk: int = 256):
    """Prefill forward.  x (b,s,D) -> (y (b,s,D), cache)."""
    bsz, s, _ = x.shape
    d_inner, heads, n = mamba_dims(cfg)
    z = linear(p["in_z"], x, x.dtype)
    xin_raw = linear(p["in_x"], x, x.dtype)
    b_raw = linear(p["in_b"], x, x.dtype)
    c_raw = linear(p["in_c"], x, x.dtype)
    dt = linear(p["in_dt"], x, torch.float32)

    xin = _causal_conv(xin_raw, p["conv_x"])
    b_ssm = _causal_conv(b_raw, p["conv_b"])
    c_ssm = _causal_conv(c_raw, p["conv_c"])

    dt = softplus(dt + p["dt_bias"])  # (b,s,h)
    a = -torch.exp(p["a_log"])  # (h,)
    log_da = dt * a
    xh = xin.reshape(bsz, s, heads, cfg.ssm_head_dim)
    x_scaled = xh.to(torch.float32) * dt[..., None]

    # Pad the sequence to a chunk multiple with identity steps (decay
    # exp(0) = 1, zero input): exact for the output and the state, then
    # slice back.
    chunk = min(chunk, s)
    pad = (-s) % chunk
    b_pad, c_pad = b_ssm.to(torch.float32), c_ssm.to(torch.float32)
    if pad:
        def zpad(t):
            return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))

        x_scaled, log_da, b_pad, c_pad = zpad(x_scaled), zpad(log_da), zpad(b_pad), zpad(c_pad)

    y, final_state = _ssd_chunked(x_scaled, log_da, b_pad, c_pad, chunk)
    y = y[:, :s]
    y = y + xh.to(torch.float32) * p["d_skip"][None, None, :, None]
    y = y.reshape(bsz, s, d_inner).to(x.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    take = CONV_WIDTH - 1
    cache = {
        "conv_x": xin_raw[:, -take:, :].to(x.dtype),
        "conv_b": b_raw[:, -take:, :].to(x.dtype),
        "conv_c": c_raw[:, -take:, :].to(x.dtype),
        "ssm": final_state,
    }
    return linear(p["out_proj"], y, x.dtype), cache


def init_mamba_cache(cfg, batch: int, dtype, device="cuda"):
    d_inner, heads, n = mamba_dims(cfg)
    dev = resolve_device(device)
    take = CONV_WIDTH - 1
    return {
        "conv_x": torch.zeros((batch, take, d_inner), dtype=dtype, device=dev),
        "conv_b": torch.zeros((batch, take, n), dtype=dtype, device=dev),
        "conv_c": torch.zeros((batch, take, n), dtype=dtype, device=dev),
        "ssm": torch.zeros((batch, heads, cfg.ssm_head_dim, n), dtype=torch.float32,
                           device=dev),
    }


def _conv_step(window: torch.Tensor, conv_p) -> torch.Tensor:
    """window (b,W,c) -> conv output at the last position (b,c)."""
    w = conv_p["w"].to(window.dtype)
    return F.silu(torch.einsum("bwc,wc->bc", window, w) + conv_p["b"].to(window.dtype))


def mamba_decode_step(p, cfg, x, cache):
    """One-token decode.  x (b,1,D) -> (y (b,1,D), cache').  The SSM state
    of ``cache`` is updated in place and is the state of ``cache'``."""
    bsz = x.shape[0]
    d_inner, heads, n = mamba_dims(cfg)
    z = linear(p["in_z"], x, x.dtype)
    xin_raw = linear(p["in_x"], x, x.dtype)
    b_raw = linear(p["in_b"], x, x.dtype)
    c_raw = linear(p["in_c"], x, x.dtype)
    dt = linear(p["in_dt"], x, torch.float32)

    win_x = torch.cat([cache["conv_x"], xin_raw], dim=1)
    win_b = torch.cat([cache["conv_b"], b_raw], dim=1)
    win_c = torch.cat([cache["conv_c"], c_raw], dim=1)
    xin = _conv_step(win_x, p["conv_x"])
    b_ssm = _conv_step(win_b, p["conv_b"])
    c_ssm = _conv_step(win_c, p["conv_c"])

    dt = softplus(dt[:, 0] + p["dt_bias"])  # (b,h)
    a = -torch.exp(p["a_log"])
    da = torch.exp(dt * a)  # (b,h)
    xh = xin.reshape(bsz, heads, cfg.ssm_head_dim).to(torch.float32)
    bx = torch.einsum("bhp,bn->bhpn", xh * dt[..., None], b_ssm.to(torch.float32))
    ssm = cache["ssm"].mul_(da[..., None, None]).add_(bx)
    y = torch.einsum("bhpn,bn->bhp", ssm, c_ssm.to(torch.float32))
    y = y + xh * p["d_skip"][None, :, None]
    y = y.reshape(bsz, 1, d_inner).to(x.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    cache = {"conv_x": win_x[:, 1:], "conv_b": win_b[:, 1:], "conv_c": win_c[:, 1:], "ssm": ssm}
    return linear(p["out_proj"], y, x.dtype), cache
