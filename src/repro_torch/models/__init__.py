from repro_torch.models.transformer import (  # noqa: F401
    ModelConfig,
    decode_step,
    forward,
    init_cache,
    init_params,
    logits_fn,
    loss_fn,
    prefill,
)
