"""H2O-Danube3 4B [arXiv:2401.16818] — llama+mistral mix with SWA.

24L  d_model=3840  32H (GQA kv=8, head_dim=120)  d_ff=10240  vocab=32000.
Sliding-window attention throughout (mistral-style, window 4096) ->
long_500k runs with O(window) ring caches.
"""

from repro_torch.configs import ArchSpec
from repro_torch.models import ModelConfig

ARCH = ArchSpec(
    name="h2o-danube-3-4b",
    family="dense",
    source="arXiv:2401.16818",
    model=ModelConfig(
        name="h2o-danube-3-4b",
        num_layers=24,
        d_model=3840,
        num_heads=32,
        num_kv_heads=8,
        head_dim=120,
        d_ff=10240,
        vocab_size=32000,
        mlp_type="swiglu",
        layer_pattern=("swa",),
        window=4096,
        rope_theta=10_000.0,
        long_context_ok=True,
    ),
    smoke=ModelConfig(
        name="danube-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        mlp_type="swiglu",
        layer_pattern=("swa",),
        window=8,
        remat=False,
    ),
    microbatches=16,
    notes="head_dim=120 (not MXU-128-aligned — see roofline notes); SWA 4096",
)
