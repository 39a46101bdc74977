"""Carry the JAX package's resampler state across to the port and back.

A resampler has no trained weights; its state is keys, particle and weight
arrays, model parameters and the spec.  Everything crosses as numpy, so this
module needs neither package's import of the other:

* JAX key data (``jax.random.key_data(key)``: ``uint32[..., 2]``) <-> port
  keys (``int64[..., 2]``, the same words);
* particle, weight and log-weight arrays <-> tensors, bit for bit;
* UNGM ``theta`` dicts <-> dicts of float32 tensors;
* the fields of a JAX ``MegopolisSpec`` or ``MetropolisSpec`` -> the port's
  spec of the same family, and back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.spec import MegopolisSpec, MetropolisSpec, ResamplerSpec

#: JAX backends whose kernels the port's ``cuda`` backend replaces.
_KERNEL_BACKENDS = ("pallas", "pallas_interpret")


def key_from_jax(key_data) -> torch.Tensor:
    """JAX raw key data ``uint32[..., 2]`` -> port key ``int64[..., 2]``."""
    data = np.asarray(key_data)
    if data.dtype != np.uint32 or data.shape[-1:] != (2,):
        raise ValueError(f"expected uint32[..., 2] key data; got {data.dtype}{data.shape}")
    return torch.from_numpy(data.astype(np.int64))


def key_to_jax(key: torch.Tensor) -> np.ndarray:
    """Port key ``int64[..., 2]`` -> JAX raw key data ``uint32[..., 2]``
    (``jax.random.wrap_key_data`` or a legacy key array takes it)."""
    data = key.detach().cpu().numpy()
    if data.shape[-1:] != (2,) or data.min(initial=0) < 0 or data.max(initial=0) > 0xFFFFFFFF:
        raise ValueError(f"not a key: shape {data.shape}")
    return data.astype(np.uint32)


def array_from_jax(x, device="cpu") -> torch.Tensor:
    """A particle, weight or log-weight array (numpy or anything
    ``np.asarray`` takes) -> tensor on ``device``, bits unchanged."""
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def array_to_jax(x: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy array for ``jnp.asarray``, bits unchanged."""
    return x.detach().cpu().numpy()


def theta_from_jax(theta: dict, device="cpu") -> dict:
    """UNGM scenario parameters (``{"amp", "obs_var"}``, scalars or ``[S]``)
    -> float32 tensors."""
    return {name: array_from_jax(np.asarray(v, np.float32), device) for name, v in theta.items()}


def theta_to_jax(theta: dict) -> dict:
    return {name: array_to_jax(v) for name, v in theta.items()}


#: The port's spec class of each ported JAX family, by the family's name.
_FAMILIES = {cls.name: cls for cls in (MegopolisSpec, MetropolisSpec)}


def spec_from_jax(spec) -> ResamplerSpec:
    """A JAX ``MegopolisSpec`` or ``MetropolisSpec`` -> the port's spec of the
    same family, field by field; the pallas backends map to ``cuda``, the
    others raise in the port's spec as not yet ported.  Another family
    raises ``NotImplementedError``."""
    cls = _FAMILIES.get(spec.name)
    if cls is None:
        raise NotImplementedError(
            f"spec_from_jax: the {spec.name!r} family is not ported yet "
            "(ROADMAP Queue A, item 5: baseline families)"
        )
    fields = {f.name: getattr(spec, f.name) for f in dataclasses.fields(cls)}
    if fields["backend"] in _KERNEL_BACKENDS:
        fields["backend"] = "cuda"
    return cls(**fields)


def spec_to_jax(spec: ResamplerSpec) -> dict:
    """A port spec -> the fields of the JAX spec of the same family whose
    kernels it runs (``backend="pallas"``); ``MegopolisSpec(**fields)`` or
    ``MetropolisSpec(**fields)`` rebuilds it."""
    return dict(dataclasses.asdict(spec), backend="pallas")
