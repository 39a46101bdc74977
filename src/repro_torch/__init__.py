"""PyTorch + CUDA port of the Megopolis resampler (the ``repro`` package's
twin for NVIDIA Hopper).

Each module sits at the same relative path as its JAX counterpart under
``repro``.  The package imports ``torch`` and never ``jax`` or ``repro``.

Device rule: entry points that create tensors (``run_filter``,
``run_filter_bank``, ``simulate``, ``model.init``, ``gaussian_weights``)
default to ``device="cuda"`` and raise when no card is present unless the
caller passes ``device="cpu"``.  The resampler entries follow their inputs'
device: on a CUDA tensor they launch the hand-written kernel (or raise),
on a CPU tensor they run the kernel's plain PyTorch version.
"""

import torch


def resolve_device(device) -> torch.device:
    """The device rule for tensor-creating entry points: ``cuda`` needs a
    card, and there is no silent fallback to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: device='cuda' requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain versions on the CPU"
        )
    return dev
