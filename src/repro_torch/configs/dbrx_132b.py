"""DBRX 132B [hf:databricks/dbrx-base] — fine-grained MoE, 16 experts top-4.

40L  d_model=6144  48H (GQA kv=8, head_dim=128)  d_ff=10752 per expert,
vocab=100352, 16e top-4.  Experts shard 1/chip over the 16-way 'model' axis
(expert parallelism).  Pure full attention -> long_500k skipped.
"""

from repro_torch.configs import ArchSpec
from repro_torch.models import ModelConfig

ARCH = ArchSpec(
    name="dbrx-132b",
    family="moe",
    source="hf:databricks/dbrx-base",
    model=ModelConfig(
        name="dbrx-132b",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=10752,
        vocab_size=100352,
        mlp_type="swiglu",
        layer_pattern=("attn",),
        num_experts=16,
        top_k=4,
        rope_theta=500_000.0,
        long_context_ok=False,
    ),
    smoke=ModelConfig(
        name="dbrx-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        mlp_type="swiglu",
        layer_pattern=("attn",),
        num_experts=4,
        top_k=2,
        remat=False,
    ),
    microbatches=16,
    moment_dtype="bfloat16",
    notes="16 experts top-4 (fine-grained); EP = 1 expert/chip at TP16",
)
