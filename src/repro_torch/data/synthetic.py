"""Deterministic, shard-aware, checkpointable synthetic LM token stream, after
``repro.data.synthetic``.

Every token is a pure function of ``(seed, step, global_row, position)``
through the murmur3 finalizer (``kernels.common.hash_bits``, the counter
hash of the resampler kernels), so:

  * **shard-aware**: a host owning rows [lo, hi) makes exactly its slice;
  * **checkpointable**: the stream position is the step integer in the
    checkpoint manifest, so a resume is exact;
  * **elastic**: after a re-mesh, new hosts compute their new row ranges
    from the same (seed, step).

Targets are next-token: inputs shifted by one within the same generated
row of length seq_len + 1.

Token distribution: with probability 3/4 a token of the 16-token "head",
else uniform over the vocab, which leaves next-token prediction a learnable
gap of about 2 nats between the random-init loss (~ln V) and the unigram
entropy.

The tokens equal the JAX package's bit for bit at every ``(seed, step, row
range)``.  Its uint32 arithmetic runs here as masked ``int64``: the lane
``row·(S+1) + pos`` wraps mod 2^32 where the JAX package's does.  The
tensors are made on ``device`` (``cuda`` unless the caller asks for the
CPU), the twin of the JAX package's on-device ``jax_batch``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.kernels.common import MASK32, hash_bits

HEAD_TOKENS = 16  # support of the high-probability head
HEAD_WEIGHT = 12  # head probability = HEAD_WEIGHT / 16 (= 3/4)


def _mixture_tokens(bits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Hash bits (uint32 values in ``int64``) -> head-heavy int32 tokens.

    Disjoint bit ranges pick the branch (the top 4 bits), the head token
    (bits 16..) and the tail token (all bits, mod V), three independent
    streams of one counter draw."""
    head = (bits >> 16) % min(HEAD_TOKENS, vocab_size)
    tail = bits % vocab_size
    pick_head = (bits >> 28) < HEAD_WEIGHT
    return torch.where(pick_head, head, tail).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class SyntheticLMStream:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0x5EED

    def batch(self, step: int, row_lo: int = 0, row_hi: int | None = None, *,
              device="cuda") -> dict:
        """Rows [row_lo, row_hi) of the global batch at ``step`` on ``device``:
        ``{"inputs": int32[rows, S], "targets": int32[rows, S]}``."""
        dev = resolve_device(device)
        row_hi = self.global_batch if row_hi is None else row_hi
        rows = torch.arange(row_lo, row_hi, dtype=torch.int64, device=dev)
        pos = torch.arange(self.seq_len + 1, dtype=torch.int64, device=dev)
        # lane index = global_row·(S+1) + position mod 2^32; iteration = step
        lane = (rows[:, None] * (self.seq_len + 1) + pos[None, :]) & MASK32
        bits = hash_bits(self.seed & MASK32, lane, int(step) & MASK32)
        toks = _mixture_tokens(bits, self.vocab_size)
        return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
