"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-*] — MoE 128e top-1.

48L  d_model=5120  40H (GQA kv=8, head_dim=128)  d_ff=8192 per expert,
vocab=202048, 128 experts top-1 + 1 shared expert, early fusion.
Interleaved chunked-local attention (3 local : 1 global, iRoPE-style) is
modelled as SWA(8192):global 3:1 -> long_500k runs.

Training posture (the JAX package's, DESIGN.md §8): 2-D sharded params
(TP x FSDP), bf16 optimizer moments, 16 microbatches.  In the port its MoE
layers wait for ``models/moe.py`` (ROADMAP Queue A item 11).
"""

from repro_torch.configs import ArchSpec
from repro_torch.models import ModelConfig

ARCH = ArchSpec(
    name="llama4-maverick-400b-a17b",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E (family config, Maverick sizes)",
    model=ModelConfig(
        name="llama4-maverick-400b-a17b",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        mlp_type="swiglu",
        layer_pattern=("swa", "swa", "swa", "attn"),
        window=8192,  # chunked-local approximated as sliding window
        num_experts=128,
        top_k=1,
        num_shared_experts=1,
        moe_layer_period=2,  # interleaved MoE: every other layer routes
        d_ff_dense=16384,  # dense-layer FFN width (intermediate_size_mlp)
        rope_theta=500_000.0,
        long_context_ok=True,
    ),
    smoke=ModelConfig(
        name="llama4-smoke",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        mlp_type="swiglu",
        layer_pattern=("swa", "attn"),
        window=8,
        num_experts=8,
        top_k=1,
        num_shared_experts=1,
        moe_layer_period=2,
        d_ff_dense=256,
        remat=False,
    ),
    microbatches=16,
    moment_dtype="bfloat16",
    notes="128e top-1 + shared expert; 3:1 chunked-local:global; "
          "EP = 8 experts/chip at TP16",
)
