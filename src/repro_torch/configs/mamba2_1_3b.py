"""Mamba2 1.3B [arXiv:2405.21060] — pure SSM (SSD), attention-free.

48L  d_model=2048  (attn-free, d_ff=0)  vocab=50280 (padded to 50304 =
393*128 for clean 16-way TP of the embedding/lm_head — standard vocab
padding, cf. GPT-NeoX)  ssm_state=128.  Attention-free -> long_500k runs;
decode state is O(d_inner * ssm_state) per layer, constant in context.
"""

from repro_torch.configs import ArchSpec
from repro_torch.models import ModelConfig

ARCH = ArchSpec(
    name="mamba2-1.3b",
    family="ssm",
    source="arXiv:2405.21060",
    model=ModelConfig(
        name="mamba2-1.3b",
        num_layers=48,
        d_model=2048,
        num_heads=32,  # unused (attn-free); keeps head_dim derivation happy
        num_kv_heads=32,
        d_ff=0,  # mamba blocks carry no MLP
        vocab_size=50304,  # 50280 padded to a multiple of 128*16
        layer_pattern=("mamba",),
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        long_context_ok=True,
    ),
    smoke=ModelConfig(
        name="mamba2-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=512,
        layer_pattern=("mamba",),
        ssm_state=8,
        ssm_head_dim=16,
        ssm_chunk=4,
        remat=False,
    ),
    microbatches=16,
    notes="SSD (state-space duality); vocab padded 50280 -> 50304",
)
