"""The decoder LM, after ``repro.models.transformer``: one ``ModelConfig`` and a
per-layer ``layer_pattern`` of block kinds.

  * ``attn``        — global GQA attention block (+ MLP or MoE)
  * ``swa``         — sliding-window attention block (+ MLP or MoE)
  * ``mamba``       — Mamba2/SSD mixer block (no MLP; the SSM is the mixer)
  * ``shared_attn`` — Zamba2-style block whose attention+MLP params are
                      shared by every such layer (stored once)

Pre-norm residual wiring throughout; the layers run as a Python loop.  The
param tree is the JAX package's, leaf for leaf (``convert.params_from_jax``
carries one across), and ``init_params`` draws it from the JAX package's
key tree through ``repro_torch.random``.  Training: ``loss_fn`` (chunked
vocab cross entropy) over ``forward``, which recomputes each layer in the
backward (``torch.utils.checkpoint``, the JAX package's per-layer
``jax.checkpoint``) when ``cfg.remat`` is set and autograd is recording.
Serving: ``init_cache``, ``prefill``, ``decode_step``.  The sharding trees
(``param_pspecs``, ``cache_pspecs``, ``partitioning.logical``) wait for the
sharding slice (ROADMAP Queue A item A11f).  A ``mamba`` layer's decode
cache is its conv windows and SSM state (``mamba2.init_mamba_cache``)
beside the attention layers' K/V.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import random as trandom
from repro_torch import resolve_device
from repro_torch.models.attention import attention, decode_attention, init_attention
from repro_torch.models.layers import (
    embed,
    init_embedding,
    init_linear,
    init_rmsnorm,
    linear,
    rmsnorm,
)
from repro_torch.models.mamba2 import (
    init_mamba,
    init_mamba_cache,
    mamba_block,
    mamba_decode_step,
)
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.models.moe import init_moe, moe

#: The layer kinds of ``layer_pattern``.
LAYER_KINDS = ("attn", "swa", "shared_attn", "mamba")
#: Leaves of the expert weights, of which a token uses top_k of num_experts
#: (``num_active_params``, the JAX package's rule).
_EXPERT_LEAVES = ("/w1/", "/w2/", "/w3/")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    mlp_type: str = "swiglu"
    qk_norm: bool = False
    layer_pattern: Tuple[str, ...] = ("attn",)  # cycled over num_layers
    window: int = 0  # sliding window for "swa" layers
    # MoE (applies to attn/swa layers when num_experts > 0)
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    moe_layer_period: int = 1  # MoE every k-th layer (llama4: 2); dense between
    d_ff_dense: int = 0  # FFN width of the NON-MoE layers (0 -> d_ff)
    # SSM (mamba layers)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # misc
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    # decode KV cache storage dtype (None -> dtype)
    cache_dtype: Any = None
    remat: bool = True  # training only: per-layer recompute in the backward
    loss_chunk: int = 1024
    q_chunk: int = 4096
    embeds_input: bool = False  # modality-frontend stub (musicgen)
    long_context_ok: bool = False  # eligible for long_500k (sub-quadratic)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        pat = self.layer_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def is_moe_layer(self, i: int) -> bool:
        """Interleaved MoE: layer ``i`` routes through experts when the MoE
        period hits (llama4-style alternation); period 1 = every layer."""
        return self.is_moe and (i % self.moe_layer_period == self.moe_layer_period - 1)

    @property
    def ff_dense(self) -> int:
        return self.d_ff_dense or self.d_ff

    def num_params(self) -> int:
        """Total parameter count, from the shapes alone: ``init_params`` on
        the ``meta`` device, which allocates nothing."""
        return sum(leaf.numel() for _, leaf in _named_shapes(self))

    def num_active_params(self) -> int:
        """Active params per token (MoE: top_k of num_experts of each expert
        weight, plus everything else), by the JAX package's rule."""
        if not self.is_moe:
            return self.num_params()
        total = 0
        for path, leaf in _named_shapes(self):
            if any(name in path for name in _EXPERT_LEAVES):
                total += int(leaf.numel() * self.top_k / self.num_experts)
            else:
                total += leaf.numel()
        return total


def _named_leaves(tree, path=""):
    """``(path, leaf)`` of every leaf, the path's keys joined by ``/`` as the
    JAX package's ``keystr_simple`` joins them."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{path}/{i}" if path else str(i))
    else:
        yield path, tree


def _named_shapes(cfg: ModelConfig):
    return _named_leaves(init_params(trandom.PRNGKey(0), cfg, device="meta"))


def check_supported(cfg: ModelConfig):
    """Raise ``ValueError`` for a layer kind outside ``LAYER_KINDS``."""
    unknown = sorted(set(cfg.layer_kinds) - set(LAYER_KINDS))
    if unknown:
        raise ValueError(f"{cfg.name}: unknown layer kinds {unknown}")


# --------------------------------------------------------------------- init
def _init_block(key, cfg: ModelConfig, kind: str, device, layer_idx: int = -1):
    if kind == "mamba":
        return {"norm": init_rmsnorm(cfg.d_model, device), "mamba": init_mamba(key, cfg, device)}
    k1, k2 = trandom.split(key)
    p = {
        "norm1": init_rmsnorm(cfg.d_model, device),
        "attn": init_attention(k1, cfg, device),
        "norm2": init_rmsnorm(cfg.d_model, device),
    }
    if layer_idx >= 0 and cfg.is_moe_layer(layer_idx):
        p["moe"] = init_moe(k2, cfg, device)
    else:
        p["mlp"] = init_mlp(k2, cfg.d_model, cfg.ff_dense, cfg.mlp_type, device)
    return p


def init_params(key, cfg: ModelConfig, device="cuda"):
    """The JAX package's ``init_params`` on the same key tree: ``split(key,
    L + 4)``, layer ``i`` from key ``i``, the shared block from ``-3``, the
    head from ``-2``, the embedding from ``-1``.  The draws are
    ``random.normal``'s, within its 3 ULP of ``jax.random.normal`` (ROADMAP
    Queue C item 9).  Float32 leaves on ``device`` (``cuda`` unless asked
    for the CPU; ``meta`` for shapes only)."""
    check_supported(cfg)
    dev = torch.device(device) if str(device) == "meta" else resolve_device(device)
    keys = trandom.split(key, cfg.num_layers + 4)
    params: dict = {"final_norm": init_rmsnorm(cfg.d_model, dev)}
    if not cfg.embeds_input:
        params["embed"] = init_embedding(keys[-1], cfg.vocab_size, cfg.d_model, dev)
    params["lm_head"] = init_linear(keys[-2], cfg.d_model, cfg.vocab_size, device=dev)
    kinds = cfg.layer_kinds
    params["layers"] = [{} if kind == "shared_attn" else _init_block(keys[i], cfg, kind, dev, i)
                        for i, kind in enumerate(kinds)]
    if "shared_attn" in kinds:
        params["shared"] = _init_block(keys[-3], cfg, "attn", dev)
    return params


# ------------------------------------------------------------------ forward
def _block_params(params, kind: str, i: int):
    return params["shared"] if kind == "shared_attn" else params["layers"][i]


def _inputs(params, cfg: ModelConfig, inputs: torch.Tensor) -> torch.Tensor:
    if cfg.embeds_input:
        return inputs.to(cfg.dtype)
    return embed(params["embed"], inputs, cfg.dtype)


def _feed_forward(p, cfg: ModelConfig, h):
    return moe(p["moe"], cfg, h) if "moe" in p else mlp(p["mlp"], h, cfg.mlp_type)


def _block_forward(p, cfg: ModelConfig, kind: str, x, positions):
    """One block; returns ``(x', state)``: ``(k, v)`` of an attention block,
    the decode cache of a ``mamba`` block."""
    if kind == "mamba":
        h, cache = mamba_block(p["mamba"], cfg, rmsnorm(p["norm"], x, cfg.norm_eps),
                               chunk=cfg.ssm_chunk)
        return x + h, cache
    window = cfg.window if kind == "swa" else 0
    a, kv = attention(p["attn"], cfg, rmsnorm(p["norm1"], x, cfg.norm_eps), positions,
                      window=window, q_chunk=cfg.q_chunk)
    x = x + a
    h = rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + _feed_forward(p, cfg, h), kv


def _block_output(p, cfg: ModelConfig, kind: str, x, positions):
    """The block's ``x'`` alone: what a recomputed layer keeps (its K/V or
    SSM state would otherwise stay alive until the backward)."""
    return _block_forward(p, cfg, kind, x, positions)[0]


def forward(params, cfg: ModelConfig, inputs, positions=None):
    """Trunk + final norm.  ``inputs``: int tokens (B,S) or embeds (B,S,D).
    Returns hidden states (B,S,D) in cfg.dtype.  With ``cfg.remat`` and
    autograd recording, each layer keeps only its input for the backward
    and runs again there."""
    check_supported(cfg)
    x = _inputs(params, cfg, inputs)
    b, s = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    remat = cfg.remat and torch.is_grad_enabled()
    for i, kind in enumerate(cfg.layer_kinds):
        p = _block_params(params, kind, i)
        if remat:
            x = checkpoint(_block_output, p, cfg, kind, x, positions, use_reentrant=False)
        else:
            x = _block_output(p, cfg, kind, x, positions)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def logits_fn(params, cfg: ModelConfig, h):
    return linear(params["lm_head"], h, cfg.dtype)


def loss_fn(params, cfg: ModelConfig, batch):
    """Chunked-vocab cross entropy.  batch: {"inputs", "targets" (B,S)}; a
    target below 0 is masked out.  Sequence-chunked so the (chunk, V)
    float32 logits stay bounded; the mean over the unmasked targets."""
    h = forward(params, cfg, batch["inputs"])
    s = h.shape[1]
    targets = batch["targets"]
    chunk = min(cfg.loss_chunk, s)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, s, chunk):
        hi = min(s, lo + chunk)
        logits = logits_fn(params, cfg, h[:, lo:hi]).to(torch.float32)
        tgt = targets[:, lo:hi]
        lse = torch.logsumexp(logits, dim=-1)
        # The JAX package's gather wraps index -1; torch's refuses it.  The
        # masked targets read index 0 instead and count for nothing.
        true = torch.gather(logits, -1, tgt.clamp_min(0).to(torch.int64)[..., None])[..., 0]
        mask = (tgt >= 0).to(torch.float32)
        total = total + torch.sum((lse - true) * mask)
        count = count + torch.sum(mask)
    return total / torch.clamp_min(count, 1.0)


# ------------------------------------------------------------------ serving
def _ring(cfg: ModelConfig, kind: str, max_seq: int) -> int:
    return max_seq if (kind != "swa" or cfg.window == 0) else min(max_seq, cfg.window)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    """Per-layer decode caches: ``{"kv": (k, v)}``, each ``(batch, ring, Hkv,
    hd)``, of an attention layer (window layers get O(window) rings); the
    conv windows and SSM state of a ``mamba`` layer, in the compute dtype."""
    check_supported(cfg)
    dev = resolve_device(device)
    cdt = cfg.cache_dtype or cfg.dtype
    caches = []
    for kind in cfg.layer_kinds:
        if kind == "mamba":
            caches.append(init_mamba_cache(cfg, batch, cfg.dtype, dev))
            continue
        shape = (batch, _ring(cfg, kind, max_seq), cfg.num_kv_heads, cfg.head_dim)
        caches.append({"kv": (torch.zeros(shape, dtype=cdt, device=dev),
                              torch.zeros(shape, dtype=cdt, device=dev))})
    return caches


def prefill(params, cfg: ModelConfig, inputs, max_seq: int):
    """Full-sequence forward that also fills the decode caches.
    Returns (logits_last (B,V), caches)."""
    check_supported(cfg)
    x = _inputs(params, cfg, inputs)
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    caches = []
    for i, kind in enumerate(cfg.layer_kinds):
        x, state = _block_forward(_block_params(params, kind, i), cfg, kind, x, positions)
        if kind == "mamba":
            caches.append(state)
        else:
            caches.append({"kv": _ring_from_prefill(*state, _ring(cfg, kind, max_seq), max_seq,
                                                    cfg)})
    h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_fn(params, cfg, h[:, -1]), caches


def _ring_from_prefill(k, v, ring: int, max_seq: int, cfg: ModelConfig):
    """Place prefill K/V (positions 0..s-1) into a ring cache of length
    ``ring`` that serves up to ``max_seq`` positions."""
    b, s = k.shape[0], k.shape[1]
    cdt = cfg.cache_dtype or cfg.dtype
    kc = torch.zeros((b, ring, cfg.num_kv_heads, cfg.head_dim), dtype=cdt, device=k.device)
    vc = torch.zeros_like(kc)
    take = min(s, ring)
    slots = torch.remainder(torch.arange(s - take, s, device=k.device), ring)
    kc[:, slots] = k[:, s - take:].to(cdt)
    vc[:, slots] = v[:, s - take:].to(cdt)
    return kc, vc


def decode_step(params, cfg: ModelConfig, inputs, caches, pos: int):
    """One decode step.  ``inputs``: int tokens (B,1) or embeds (B,1,D);
    ``pos``: the current position (an int).  Writes the new K/V and SSM
    states into ``caches`` in place (``attention.decode_attention``,
    ``mamba2.mamba_decode_step``) and returns (logits (B,V), caches)."""
    check_supported(cfg)
    x = _inputs(params, cfg, inputs)
    new_caches = []
    for i, kind in enumerate(cfg.layer_kinds):
        p = _block_params(params, kind, i)
        if kind == "mamba":
            h, cache = mamba_decode_step(p["mamba"], cfg, rmsnorm(p["norm"], x, cfg.norm_eps),
                                         caches[i])
            x = x + h
            new_caches.append(cache)
            continue
        window = cfg.window if kind == "swa" else 0
        a, kv = decode_attention(p["attn"], cfg, rmsnorm(p["norm1"], x, cfg.norm_eps),
                                 caches[i]["kv"], pos, window=window)
        x = x + a
        h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = x + _feed_forward(p, cfg, h2)
        new_caches.append({"kv": kv})
    h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_fn(params, cfg, h[:, -1]), new_caches
