"""Serving entry point, after ``repro.launch.serve``: prefill, then SMC-particle
decode.

Batched requests: each request is a prompt of token ids; SMC mode treats
the batch as the particle population (the paper's resampler running live
inside the decode loop, one fused step kernel launch a token on ``cuda``).
The weights are random, drawn from ``seed``; there is no tokenizer.

    python -m repro_torch.launch.serve --arch qwen3-0.6b            # smoke size, on the card
    python -m repro_torch.launch.serve --arch qwen3-0.6b --full     # published width
    python -m repro_torch.launch.serve --arch qwen3-0.6b --device cpu --num-particles 1024
    python -m repro_torch.launch.serve --arch mamba2-1.3b --device cpu  # SSM, smoke size
    python -m repro_torch.launch.serve --arch dbrx-132b --device cpu    # MoE, smoke size

The particle count defaults to ``DECODE_PARTICLES`` = 1024, not the JAX
package's 64: a registry name resolves to the hand-written kernels, which
take whole tiles of 1024 particles (``N % 1024 == 0``, as the JAX package's
kernel backends do), so the default runs on the card as it stands.  The
device defaults to ``cuda`` and raises without a card unless
``--device cpu`` is given (the kernels' plain versions then run).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import random as trandom
from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.models import init_params, prefill
from repro_torch.smc import SMCDecodeConfig, smc_decode

#: The kernels' tile of particles, the JAX package's own decode audit size
#: (``repro.analysis.consumers.DECODE_PARTICLES``).
DECODE_PARTICLES = 1024


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_once(arch_name: str, *, smoke: bool = True, num_particles: int = DECODE_PARTICLES,
               prompt_len: int = 16, new_tokens: int = 32, resampler="megopolis",
               seed: int = 0, target_temp: float = 0.7, device="cuda"):
    """Prefill ``num_particles`` random prompts of ``prompt_len`` tokens and
    decode ``new_tokens`` by SMC, in float32 as the JAX package's ``serve_once`` runs it.
    ``resampler`` is a registry name or a spec (``SMCDecodeConfig``): every
    family's kernels copy the int32 token buffer, beside any plane dtype.
    Returns the tokens, log-weights, resamples, final ESS and the seconds of
    prefill and decode (the card synchronised)."""
    dev = resolve_device(device)
    arch = get_arch(arch_name)
    cfg = arch.smoke if smoke else arch.model
    cfg = dataclasses.replace(cfg, dtype=torch.float32, remat=False)
    key = trandom.PRNGKey(seed)
    k_param, k_prompt, k_decode = trandom.split(key, 3)
    params = init_params(k_param, cfg, device=dev)

    max_seq = prompt_len + new_tokens
    if cfg.embeds_input:
        prompts = trandom.normal(k_prompt, (num_particles, prompt_len, cfg.d_model), device=dev)
        first = torch.zeros((num_particles,), dtype=torch.int32, device=dev)
    else:
        prompts = trandom.randint(k_prompt, (num_particles, prompt_len), 0, cfg.vocab_size,
                                  device=dev)
        first = prompts[:, -1]

    _sync(dev)
    t0 = time.perf_counter()
    # Handed to the decode, not held here: its first gather frees them.
    caches = [prefill(params, cfg, prompts, max_seq)[1]]
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    smc_cfg = SMCDecodeConfig(num_particles=num_particles, max_new_tokens=new_tokens,
                              resampler=resampler, target_temp=target_temp)
    t0 = time.perf_counter()
    tokens, log_w, stats = smc_decode(params, cfg, smc_cfg, caches.pop(), first, prompt_len,
                                      k_decode)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return {
        "tokens": tokens,
        "log_weights": log_w,
        "num_resamples": int(stats["num_resamples"]),
        "final_ess": float(stats["ess_history"][-1]),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "tok_per_s": num_particles * new_tokens / t_decode,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", action="store_true",
                    help="the published width (arch.model), not the smoke config")
    ap.add_argument("--num-particles", type=int, default=DECODE_PARTICLES)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--resampler", default="megopolis")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    out = serve_once(a.arch, smoke=not a.full, num_particles=a.num_particles,
                     prompt_len=a.prompt_len, new_tokens=a.new_tokens, resampler=a.resampler,
                     device=a.device)
    print(f"{a.arch}: decoded {a.num_particles}x{a.new_tokens} tokens; "
          f"resamples={out['num_resamples']} final_ess={out['final_ess']:.1f} "
          f"prefill={out['prefill_s']*1e3:.0f}ms decode={out['decode_s']*1e3:.0f}ms "
          f"({out['tok_per_s']:.0f} tok/s)")


if __name__ == "__main__":
    main()
