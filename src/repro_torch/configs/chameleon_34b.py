"""Chameleon 34B [arXiv:2405.09818] — early-fusion VLM, VQ image tokens.

48L  d_model=8192  64H (GQA kv=8, head_dim=128)  d_ff=22016  vocab=65536.
Early fusion: text + VQ image tokens share one stream; the VQ-GAN image
tokenizer is a STUB per the assignment — ``input_specs()`` provides
precomputed patch/token embeddings -> ``embeds_input=True``.  Chameleon's
qk-norm (their key stability fix) is on.  Full attention -> long_500k
skipped.
"""

from repro_torch.configs import ArchSpec
from repro_torch.models import ModelConfig

ARCH = ArchSpec(
    name="chameleon-34b",
    family="vlm",
    source="arXiv:2405.09818",
    model=ModelConfig(
        name="chameleon-34b",
        num_layers=48,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=22016,
        vocab_size=65536,
        mlp_type="swiglu",
        qk_norm=True,
        layer_pattern=("attn",),
        rope_theta=10_000.0,
        embeds_input=True,
        long_context_ok=False,
    ),
    smoke=ModelConfig(
        name="chameleon-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        mlp_type="swiglu",
        qk_norm=True,
        layer_pattern=("attn",),
        embeds_input=True,
        remat=False,
    ),
    microbatches=16,
    moment_dtype="bfloat16",
    notes="early-fusion VLM backbone; VQ frontend stubbed; qk-norm",
)
