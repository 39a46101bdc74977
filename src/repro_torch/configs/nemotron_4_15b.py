"""Nemotron-4 15B [arXiv:2402.16819] — dense, GQA, squared-ReLU MLP.

32L  d_model=6144  48H (GQA kv=8, head_dim=128)  d_ff=24576  vocab=256000.
Pure full attention -> long_500k skipped (DESIGN.md §5).
"""

from repro_torch.configs import ArchSpec
from repro_torch.models import ModelConfig

ARCH = ArchSpec(
    name="nemotron-4-15b",
    family="dense",
    source="arXiv:2402.16819",
    model=ModelConfig(
        name="nemotron-4-15b",
        num_layers=32,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=256000,
        mlp_type="squared_relu",
        layer_pattern=("attn",),
        rope_theta=10_000.0,
        long_context_ok=False,
    ),
    smoke=ModelConfig(
        name="nemotron-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        mlp_type="squared_relu",
        layer_pattern=("attn",),
        remat=False,
    ),
    microbatches=16,
    notes="squared-ReLU non-gated MLP; 6:1 GQA",
)
