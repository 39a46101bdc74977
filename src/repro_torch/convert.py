"""Carry the JAX package's resampler state across to the port and back.

A resampler has no trained weights; its state is keys, particle and weight
arrays, model parameters and the spec.  Everything crosses as numpy, so this
module needs neither package's import of the other:

* JAX key data (``jax.random.key_data(key)``: ``uint32[..., 2]``) <-> port
  keys (``int64[..., 2]``, the same words);
* particle, weight and log-weight arrays <-> tensors, bit for bit;
* scenario ``theta`` dicts (UNGM's, ``ais.gaussian_family``'s) <-> dicts
  of float32 tensors;
* the fields of a JAX ``MegopolisSpec``, ``MetropolisSpec``,
  ``MetropolisC1Spec``, ``MetropolisC2Spec``, ``RejectionSpec`` or
  ``PrefixSumSpec`` -> the port's spec of the same family, and back;
* a JAX ``SMCSamplerConfig`` -> the port's, field by field;
* LM parameter and cache trees (dicts, lists and tuples of arrays, the
  JAX package's ``init_params``/``prefill`` layout) <-> the same trees of
  tensors, leaf for leaf and bit for bit, and a JAX ``ModelConfig`` -> the
  port's (``dtype`` as the torch dtype).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ais.sampler import SMCSamplerConfig
from repro_torch.core.spec import JAX_BACKENDS, ResamplerSpec, spec_from_name
from repro_torch.models import ModelConfig


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


def array_from_jax(x, device="cuda") -> torch.Tensor:
    """A particle, weight or log-weight array (numpy or anything
    ``np.asarray`` takes) -> tensor on ``device``, bits unchanged.  The
    device rule of the package: ``cuda`` unless ``device="cpu"``."""
    return torch.from_numpy(np.array(x, copy=True)).to(resolve_device(device))


def array_to_jax(x: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy array for ``jnp.asarray``, bits unchanged."""
    return x.detach().cpu().numpy()


def theta_from_jax(theta: dict, device="cuda") -> dict:
    """Scenario parameters -> float32 tensors, leaf for leaf: UNGM's
    (``{"amp", "obs_var"}``, scalars or ``[S]``) and ``gaussian_family``'s
    (``{"mean": [d] or [S, d], "sigma": [] or [S]}``)."""
    return {name: array_from_jax(np.asarray(v, np.float32), device) for name, v in theta.items()}


def theta_to_jax(theta: dict) -> dict:
    return {name: array_to_jax(v) for name, v in theta.items()}


def spec_from_jax(spec) -> ResamplerSpec:
    """A JAX spec -> the port's spec of the same family, field by field (C1/C2
    with ``partition_size_bytes`` and ``warp``, rejection with
    ``max_iters``, the prefix-sum family with ``kind``), through the port's
    one registry (``core.spec.spec_from_name``); the JAX backends map to
    their counterparts (``JAX_BACKENDS``: the pallas pair to ``cuda``,
    ``xla`` to ``reference``; ``reference`` stays).  A spec of no known
    family raises ``KeyError``."""
    fields = {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}
    fields["backend"] = JAX_BACKENDS.get(fields["backend"], fields["backend"])
    fields.pop("kind", None)
    return spec_from_name(spec.name, **fields)


def sampler_config_from_jax(cfg):
    """A JAX ``SMCSamplerConfig`` -> the port's, field by field; a spec in
    ``resampler`` goes through ``spec_from_jax``, a registry name stays."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if not isinstance(fields["resampler"], str):
        fields["resampler"] = spec_from_jax(fields["resampler"])
    return SMCSamplerConfig(**fields)


def spec_to_jax(spec: ResamplerSpec) -> dict:
    """A port spec -> the fields of the JAX spec of the same family that runs
    the same thing (``backend="pallas"`` for ``cuda``, ``"reference"`` for
    ``reference``); the JAX class of the same name rebuilds it from them
    (``MetropolisC1Spec(**fields)``)."""
    return dict(dataclasses.asdict(spec),
                backend="pallas" if spec.backend == "cuda" else spec.backend)


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def params_from_jax(tree, device="cuda"):
    """A JAX parameter (or cache) tree -> the same tree of tensors on
    ``device``, every leaf's bits unchanged (``array_from_jax``)."""
    dev = resolve_device(device)
    return _map_tree(lambda leaf: array_from_jax(np.asarray(leaf), dev), tree)


def params_to_jax(tree):
    """A tree of tensors -> the same tree of numpy arrays (``array_to_jax``),
    which ``jnp.asarray`` or the JAX package's functions take."""
    return _map_tree(array_to_jax, tree)


def _torch_dtype(dtype):
    return None if dtype is None else getattr(torch, np.dtype(dtype).name)


def model_config_from_jax(cfg) -> ModelConfig:
    """A JAX ``ModelConfig`` -> the port's, field by field; ``dtype`` and
    ``cache_dtype`` become the torch dtypes of the same names."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["dtype"] = _torch_dtype(fields["dtype"])
    fields["cache_dtype"] = _torch_dtype(fields["cache_dtype"])
    return ModelConfig(**fields)
