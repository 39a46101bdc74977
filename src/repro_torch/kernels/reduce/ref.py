"""Plain PyTorch version of ``csrc/reduce.cu``: ``logsumexp_rows_ref``, the
kernel's adds in the kernel's order, used on the CPU and held bit for bit
against the kernel on the card.

The order depends on the row's length N alone (never on the number of rows
S, nor on how the launch spreads a row over the card), so a bank row reduces
exactly as the same row alone: chain ``t`` of ``LSE_NT`` takes the quads of
4 consecutive lanes ``t, t + LSE_NT, ...`` and adds ``exp(x - shift)`` of
their lanes in lane order from 0; the chains' sums are added by a fixed tree
(each warp of 32 chains halved, lanes ``l`` and ``l + 16``, then ``l + 8``,
...; then the warps' sums in warp order from warp 0's).  ``shift`` is the
row's max, or 0 where that is not finite.  This arithmetic is the fixed
order the kernel is held to: it is not edited.
Subnormals are flushed, as the kernel's ``-ftz=true`` build does: the
input, ``x - shift``, each ``exp`` and the result.  The adds of the sums
need no flush: each term is 0 or at least the smallest normal float, so no
partial sum of them is subnormal.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import flush_to_zero

#: Chains of the order (``LSE_CHAINS`` in ``csrc/reduce.cu``; the kernel sums
#: each warp of 32 of them in a warp of its own).
LSE_NT = 1024
WARP = 32


def _tree(v: torch.Tensor) -> torch.Tensor:
    """``[S, 32·W]`` chains' sums -> ``[S]`` by the kernel's fixed tree:
    each warp's 32 lanes halved, then the W warps' results added in order."""
    warps = v.reshape(v.shape[0], -1, WARP)
    while warps.shape[-1] > 1:
        half = warps.shape[-1] // 2
        warps = warps[..., :half] + warps[..., half:]
    warps = warps[..., 0]
    acc = warps[:, 0]
    for q in range(1, warps.shape[1]):
        acc = acc + warps[:, q]
    return acc


def logsumexp_rows_ref(x: torch.Tensor) -> torch.Tensor:
    """``log Σ_i exp(x[s, i])`` of ``f32[S, N]`` -> ``f32[S]``, in the
    kernel's order."""
    x = flush_to_zero(x.to(torch.float32))
    s, n = x.shape
    m = x.amax(dim=-1)
    shift = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = flush_to_zero(torch.exp(flush_to_zero(x - shift.unsqueeze(-1))))
    chunks = -(-n // (4 * LSE_NT))
    e = torch.nn.functional.pad(e, (0, chunks * 4 * LSE_NT - n)).reshape(s, chunks, LSE_NT, 4)
    acc = torch.zeros((s, LSE_NT), dtype=torch.float32, device=x.device)
    for k in range(chunks):
        for j in range(4):
            acc = acc + e[:, k, :, j]
    total = _tree(acc)
    return flush_to_zero(shift + flush_to_zero(torch.log(total)))
