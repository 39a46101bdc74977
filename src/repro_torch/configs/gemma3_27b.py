"""Gemma-3 27B [hf:google/gemma-3-*-pt] — dense, 5:1 local:global, 128k ctx.

62L  d_model=5376  32H (GQA kv=16, head_dim=128)  d_ff=21504  vocab=262144.
Five sliding-window (1024) layers per global layer -> only ~1/6 of layers
hold full-length KV, so long_500k runs (ring caches keep SWA layers
O(window); global-layer KV shards seq over 'data').
"""

from repro_torch.configs import ArchSpec
from repro_torch.models import ModelConfig

ARCH = ArchSpec(
    name="gemma3-27b",
    family="dense",
    source="hf:google/gemma-3-1b-pt (family config)",
    model=ModelConfig(
        name="gemma3-27b",
        num_layers=62,
        d_model=5376,
        num_heads=32,
        num_kv_heads=16,
        head_dim=128,
        d_ff=21504,
        vocab_size=262144,
        mlp_type="geglu",
        qk_norm=True,
        layer_pattern=("swa", "swa", "swa", "swa", "swa", "attn"),
        window=1024,
        rope_theta=1_000_000.0,
        long_context_ok=True,
    ),
    smoke=ModelConfig(
        name="gemma3-smoke",
        num_layers=6,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        mlp_type="geglu",
        qk_norm=True,
        layer_pattern=("swa", "swa", "attn"),
        window=8,
        remat=False,
    ),
    microbatches=16,
    moment_dtype="bfloat16",
    notes="5:1 local:global; 1024-token sliding window; GeGLU; qk-norm",
)
