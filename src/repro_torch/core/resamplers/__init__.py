"""Resampling algorithms (the paper's Algs. 2-5, 7, 8 and extras): the
reference algorithms of the port, after ``repro.core.resamplers``.

Every resampler shares one signature::

    ancestors = resampler(key, weights, num_iters, **kwargs)   # int32[N]

and a bank form (``get_resampler_batch(name)``) over ``weights[B, N]`` whose
row ``b`` equals the single call with ``split(key, B)[b]``.  They run in
plain torch ops on JAX's random streams (``repro_torch.random``) and agree
with the JAX package's reference bit for bit; the typed spec API
(``repro_torch.core.spec``, ``backend="reference"``) builds on them, and its
``cuda`` backend runs the hand-written kernels instead.
"""

from repro_torch.core.resamplers.batched import batch_rows, batch_via_vmap, split_batch_keys
from repro_torch.core.resamplers.megopolis import megopolis, megopolis_batch
from repro_torch.core.resamplers.metropolis import (
    metropolis,
    metropolis_batch,
    metropolis_c1,
    metropolis_c1_batch,
    metropolis_c2,
    metropolis_c2_batch,
)
from repro_torch.core.resamplers.prefix_sum import (
    improved_systematic,
    improved_systematic_batch,
    multinomial,
    multinomial_batch,
    residual,
    residual_batch,
    stratified,
    stratified_batch,
    systematic,
    systematic_batch,
)
from repro_torch.core.resamplers.rejection import rejection, rejection_batch

#: The typed spec API, re-exported as the JAX package does; resolved lazily
#: (``core.spec`` imports this package).
_SPEC_NAMES = (
    "MegopolisSpec", "MetropolisC1Spec", "MetropolisC2Spec", "MetropolisSpec",
    "PrefixSumSpec", "RejectionSpec", "Resampler", "ResamplerSpec", "coerce_spec",
    "get_resampler", "get_resampler_batch", "list_resamplers", "spec_for_backend",
    "spec_from_name",
)


def __getattr__(name: str):
    if name in _SPEC_NAMES:
        from repro_torch.core import spec

        return getattr(spec, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
