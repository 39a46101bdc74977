"""MusicGen-Large [arXiv:2306.05284] — decoder-only over EnCodec tokens.

48L  d_model=2048  32H (kv=32 -> MHA, head_dim=64)  d_ff=8192  vocab=2048.
The EnCodec frontend is a STUB per the assignment: ``input_specs()``
provides precomputed frame embeddings (B, S, D) -> ``embeds_input=True``.
Token-level decode (SMC particle decoding) still emits codebook ids from
the 2048-way lm_head.  Pure full attention -> long_500k skipped.
"""

from repro_torch.configs import ArchSpec
from repro_torch.models import ModelConfig

ARCH = ArchSpec(
    name="musicgen-large",
    family="audio",
    source="arXiv:2306.05284",
    model=ModelConfig(
        name="musicgen-large",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        vocab_size=2048,
        mlp_type="gelu",  # MusicGen uses plain GELU MLP
        layer_pattern=("attn",),
        rope_theta=10_000.0,
        embeds_input=True,
        long_context_ok=False,
    ),
    smoke=ModelConfig(
        name="musicgen-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=64,
        mlp_type="gelu",
        layer_pattern=("attn",),
        embeds_input=True,
        remat=False,
    ),
    microbatches=16,
    notes="audio backbone only; EnCodec frame embeddings stubbed at input",
)
