"""Qwen3 0.6B [hf:Qwen/Qwen3-0.6B] — dense, qk-norm, GQA.

28L  d_model=1024  16H (GQA kv=8, head_dim=128)  d_ff=3072  vocab=151936.
Pure full attention -> long_500k skipped.
"""

from repro_torch.configs import ArchSpec
from repro_torch.models import ModelConfig

ARCH = ArchSpec(
    name="qwen3-0.6b",
    family="dense",
    source="hf:Qwen/Qwen3-8B (family config, 0.6B sizes)",
    model=ModelConfig(
        name="qwen3-0.6b",
        num_layers=28,
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=3072,
        vocab_size=151936,
        mlp_type="swiglu",
        qk_norm=True,
        layer_pattern=("attn",),
        rope_theta=1_000_000.0,
        long_context_ok=False,
    ),
    smoke=ModelConfig(
        name="qwen3-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        mlp_type="swiglu",
        qk_norm=True,
        layer_pattern=("attn",),
        remat=False,
    ),
    microbatches=16,
    notes="qk-norm; head_dim 128 > d_model/heads (decoupled head width)",
)
