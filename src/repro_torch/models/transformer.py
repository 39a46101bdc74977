"""The decoder LM, after ``repro.models.transformer``: one ``ModelConfig`` and a
per-layer ``layer_pattern`` of block kinds.

  * ``attn``        — global GQA attention block (+ MLP)
  * ``swa``         — sliding-window attention block (+ MLP)
  * ``shared_attn`` — Zamba2-style block whose attention+MLP params are
                      shared by every such layer (stored once)
  * ``mamba``       — the Mamba2/SSD mixer: waits for ``models/mamba2.py``

Pre-norm residual wiring throughout; the layers run as a Python loop.  The
param tree is the JAX package's, leaf for leaf (``convert.params_from_jax``
carries one across), and ``init_params`` draws it from the JAX package's
key tree through ``repro_torch.random``.  Serving is ported (``init_cache``,
``prefill``, ``decode_step``); ``loss_fn``, ``remat`` and the sharding
trees (``param_pspecs``, ``cache_pspecs``, ``partitioning.logical``) belong
to training and sharding and wait for their slice (ROADMAP Queue A item
11).  MoE layers and ``mamba`` layers raise ``NotImplementedError`` naming
the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

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
from repro_torch.models.mlp import init_mlp, mlp

#: Where the layers the port does not run yet are queued (ROADMAP Queue A).
MOE_ITEM = "ROADMAP Queue A item A11b (models/moe.py)"
MAMBA_ITEM = "ROADMAP Queue A item A11c (models/mamba2.py)"


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
    remat: bool = True  # training only: the port's serving path ignores it
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
        shapes = init_params(trandom.PRNGKey(0), self, device="meta")
        return sum(leaf.numel() for leaf in _leaves(shapes))

    def num_active_params(self) -> int:
        """Active params per token: all of them for a dense model."""
        if self.is_moe:
            raise NotImplementedError(f"{self.name}: MoE layers wait for {MOE_ITEM}")
        return self.num_params()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def check_supported(cfg: ModelConfig):
    """Raise ``NotImplementedError`` for a config with a layer the port does
    not run yet (a ``mamba`` layer, an MoE layer), naming its ROADMAP item."""
    kinds = cfg.layer_kinds
    if "mamba" in kinds:
        raise NotImplementedError(f"{cfg.name}: mamba layers wait for {MAMBA_ITEM}")
    if any(cfg.is_moe_layer(i) for i in range(cfg.num_layers)):
        raise NotImplementedError(f"{cfg.name}: MoE layers wait for {MOE_ITEM}")
    unknown = sorted(set(kinds) - {"attn", "swa", "shared_attn"})
    if unknown:
        raise ValueError(f"{cfg.name}: unknown layer kinds {unknown}")


# --------------------------------------------------------------------- init
def _init_block(key, cfg: ModelConfig, device):
    k1, k2 = trandom.split(key)
    return {
        "norm1": init_rmsnorm(cfg.d_model, device),
        "attn": init_attention(k1, cfg, device),
        "norm2": init_rmsnorm(cfg.d_model, device),
        "mlp": init_mlp(k2, cfg.d_model, cfg.ff_dense, cfg.mlp_type, device),
    }


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
    params["layers"] = [{} if kind == "shared_attn" else _init_block(keys[i], cfg, dev)
                        for i, kind in enumerate(kinds)]
    if "shared_attn" in kinds:
        params["shared"] = _init_block(keys[-3], cfg, dev)
    return params


# ------------------------------------------------------------------ forward
def _block_params(params, kind: str, i: int):
    return params["shared"] if kind == "shared_attn" else params["layers"][i]


def _inputs(params, cfg: ModelConfig, inputs: torch.Tensor) -> torch.Tensor:
    if cfg.embeds_input:
        return inputs.to(cfg.dtype)
    return embed(params["embed"], inputs, cfg.dtype)


def _block_forward(p, cfg: ModelConfig, kind: str, x, positions):
    """One block; returns ``(x', (k, v))``."""
    window = cfg.window if kind == "swa" else 0
    a, kv = attention(p["attn"], cfg, rmsnorm(p["norm1"], x, cfg.norm_eps), positions,
                      window=window, q_chunk=cfg.q_chunk)
    x = x + a
    h = rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + mlp(p["mlp"], h, cfg.mlp_type), kv


def forward(params, cfg: ModelConfig, inputs, positions=None):
    """Trunk + final norm.  ``inputs``: int tokens (B,S) or embeds (B,S,D).
    Returns hidden states (B,S,D) in cfg.dtype."""
    check_supported(cfg)
    x = _inputs(params, cfg, inputs)
    b, s = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    for i, kind in enumerate(cfg.layer_kinds):
        x, _ = _block_forward(_block_params(params, kind, i), cfg, kind, x, positions)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def logits_fn(params, cfg: ModelConfig, h):
    return linear(params["lm_head"], h, cfg.dtype)


# ------------------------------------------------------------------ serving
def _ring(cfg: ModelConfig, kind: str, max_seq: int) -> int:
    return max_seq if (kind != "swa" or cfg.window == 0) else min(max_seq, cfg.window)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    """Per-layer decode caches ``[{"kv": (k, v)}]``, each ``(batch, ring,
    Hkv, hd)``; window layers get O(window) rings."""
    check_supported(cfg)
    dev = resolve_device(device)
    cdt = cfg.cache_dtype or cfg.dtype
    caches = []
    for kind in cfg.layer_kinds:
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
        x, (k, v) = _block_forward(_block_params(params, kind, i), cfg, kind, x, positions)
        caches.append({"kv": _ring_from_prefill(k, v, _ring(cfg, kind, max_seq), max_seq, cfg)})
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
    ``pos``: the current position (an int).  Writes the new K/V into
    ``caches`` in place (``attention.decode_attention``) and returns
    (logits (B,V), caches)."""
    check_supported(cfg)
    x = _inputs(params, cfg, inputs)
    new_caches = []
    for i, kind in enumerate(cfg.layer_kinds):
        p = _block_params(params, kind, i)
        window = cfg.window if kind == "swa" else 0
        a, kv = decode_attention(p["attn"], cfg, rmsnorm(p["norm1"], x, cfg.norm_eps),
                                 caches[i]["kv"], pos, window=window)
        x = x + a
        h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = x + mlp(p["mlp"], h2, cfg.mlp_type)
        new_caches.append({"kv": kv})
    h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_fn(params, cfg, h[:, -1]), new_caches
