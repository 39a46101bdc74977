"""The Megopolis comparison-index map (paper Alg. 5), after
``repro.core.resamplers.megopolis``.

The reference algorithm ``megopolis()`` (segment 32 over ``jax.random``
streams) is not ported yet (ROADMAP Queue A, item 4).  The index map lives
with the kernel primitives, which the kernels' plain versions share with the
CUDA sources; it is re-exported here under the JAX package's path.
"""

from __future__ import annotations

from repro_torch.kernels.common import megopolis_indices

__all__ = ["megopolis_indices"]
