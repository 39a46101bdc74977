"""PyTorch + CUDA port of the Megopolis resampler (the ``repro`` package's
twin for NVIDIA Hopper).

Each module sits at the same relative path as its JAX counterpart under
``repro``.  The package imports ``torch`` and never ``jax`` or ``repro``.

Device rule: entry points that create tensors (``run_filter``,
``run_filter_bank``, ``simulate``, ``model.init``, ``gaussian_weights``,
``convert.array_from_jax``, ``convert.theta_from_jax``, and the contract
checks' entry points in ``repro_torch.analysis``) default to
``device="cuda"`` and raise when no card is present unless the
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


def _init_cpu_vml():
    """Run PyTorch's CPU ``exp`` and ``log`` once on one element, on this
    thread.  They go to MKL's VML, which sets itself up at its first call;
    when that first call is split over two OpenMP threads (more than 2048
    elements) on a busy CPU, the worker's half has come back at reduced
    accuracy (up to 1.5e-4 relative for ``exp``), which moved the plain
    ``step_stats`` 1e-5 off.  Set up on one thread first, the first
    threaded call agrees bit for bit with the later ones
    (``tests/_torch_vml_first_call.py``)."""
    torch.exp(torch.zeros(1))
    torch.log(torch.ones(1))


_init_cpu_vml()
