"""Optimisation, after ``repro.optim``: AdamW with its schedule and clipping,
top-k gradient compression with error feedback, and gradient accumulation.
ZeRO-1's ``opt_state_pspecs`` comes with the sharding slice (ROADMAP Queue A
item A11f)."""

from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    tree_map,
)
from repro_torch.optim.compression import (  # noqa: F401
    CompressionConfig,
    compress_and_correct,
    compress_init,
)
from repro_torch.optim.accumulation import microbatch_grads, value_and_grad  # noqa: F401
