"""Zamba2 2.7B [arXiv:2411.15242] — Mamba2 backbone + SHARED attention block.

54L  d_model=2560  32H (kv=32, head_dim=80)  d_ff=10240  vocab=32000,
ssm_state=64.  Zamba2's signature: one attention+MLP block whose params are
shared by every 6th layer position (``shared_attn`` kind stores params once
in params["shared"]).  SSM + shared-attn -> long_500k runs; the attention
layers ring-cache is bounded by max_seq (they are full attention but few —
KV shards seq over 'data' for the 500k cell).
"""

from repro_torch.configs import ArchSpec
from repro_torch.models import ModelConfig

ARCH = ArchSpec(
    name="zamba2-2.7b",
    family="hybrid",
    source="arXiv:2411.15242",
    model=ModelConfig(
        name="zamba2-2.7b",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        d_ff=10240,
        vocab_size=32000,
        mlp_type="gelu",
        layer_pattern=("mamba", "mamba", "mamba", "mamba", "mamba", "shared_attn"),
        ssm_state=64,
        ssm_expand=2,
        ssm_head_dim=64,
        rope_theta=10_000.0,
        long_context_ok=True,
    ),
    smoke=ModelConfig(
        name="zamba2-smoke",
        num_layers=6,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        mlp_type="gelu",
        layer_pattern=("mamba", "mamba", "shared_attn"),
        ssm_state=8,
        ssm_head_dim=16,
        ssm_chunk=4,
        remat=False,
    ),
    microbatches=16,
    notes="Mamba2 + shared attention block (params stored once); "
          "SSM state gather is O(state) at resample time",
)
