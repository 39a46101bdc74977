"""Deterministic fault injection, the chaos harness's ammunition (DESIGN.md
§16), after ``repro.resilience.faults``.

Every injector is keyed and pure: the same key data gives the same fault
plane as the JAX package's injector (through ``random.py``'s threefry
twins: ``bernoulli``, ``randint``, ``split``), on either device, so a chaos
case that fails replays bit for bit.  Two kinds of primitive:

* **injectors** corrupt a clean tensor: ``inject_nan_weights`` and
  ``inject_inf_weights`` (weight planes), ``bitflip_states`` (one bit of
  each selected float32 state value), ``poison_ancestors`` (indices out of
  range);
* **generators** build whole adversarial log-weight banks: all NaN, all
  ``-inf``, one-hot, near-collapse, enumerated in ``FAULT_CLASSES``.

``validate_ancestors`` is the consumer-side tripwire: a range check that
raises the typed ``CorruptAncestorsError`` instead of letting a poisoned
gather read the wrong state.  The port's state is ``[..., N, d]`` (or
``[N]``) as its entries take it; the TPU's ``[d_pad, R, 128]`` plane layout
does not carry over.
"""

from __future__ import annotations

import torch

from repro_torch import random as trandom
from repro_torch import resolve_device
from repro_torch.resilience.errors import CorruptAncestorsError

_MASK32 = 0xFFFFFFFF


# ----------------------------------------------------------------- injectors


def inject_nan_weights(key, w: torch.Tensor, rate: float = 0.1) -> torch.Tensor:
    """NaNs in a weight or log-weight plane at ``rate`` (a keyed Bernoulli
    per element)."""
    mask = trandom.bernoulli(key, rate, tuple(w.shape), device=w.device)
    return torch.where(mask, torch.full_like(w, float("nan"), dtype=torch.float32), w)


def inject_inf_weights(key, w: torch.Tensor, rate: float = 0.1, sign: int = 1) -> torch.Tensor:
    """±inf in a weight or log-weight plane at ``rate`` (keyed)."""
    mask = trandom.bernoulli(key, rate, tuple(w.shape), device=w.device)
    return torch.where(mask, torch.full_like(w, sign * float("inf"), dtype=torch.float32), w)


def bitflip_states(key, planes: torch.Tensor, rate: float = 0.01) -> torch.Tensor:
    """Flip one uniformly drawn bit of each selected float32 value.

    Values are selected Bernoulli(``rate``); each selected value gets one of
    its 32 bits inverted: a mantissa flip perturbs it, an exponent or sign
    flip can make NaN or inf, so the guards downstream must cope with both.
    Bit arithmetic only (in ``int64``, masked to 32 bits)."""
    planes = planes.to(torch.float32)
    k_sel, k_bit = trandom.split(key)
    shape = tuple(planes.shape)
    sel = trandom.bernoulli(k_sel, rate, shape, device=planes.device)
    bit = trandom.randint(k_bit, shape, 0, 32, device=planes.device).to(torch.int64)
    bits = planes.contiguous().view(torch.int32).to(torch.int64) & _MASK32
    flipped = bits ^ (torch.ones_like(bits) << bit)
    out = torch.where(sel, flipped, bits)
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32).view(torch.float32)


def poison_ancestors(key, ancestors: torch.Tensor, n: int, rate: float = 0.05) -> torch.Tensor:
    """Replace a keyed Bernoulli subset of ancestor indices by values out of
    range (negative or ``>= n``): the plane ``validate_ancestors`` must
    catch.  The sign's draw reuses the value's key, as the JAX injector's
    does."""
    k_sel, k_val = trandom.split(key)
    shape, dev = tuple(ancestors.shape), ancestors.device
    sel = trandom.bernoulli(k_sel, rate, shape, device=dev)
    bad = trandom.randint(k_val, shape, n, 2 * n + 1, device=dev)
    sign = torch.where(trandom.bernoulli(k_val, 0.5, shape, device=dev),
                       torch.ones_like(bad), -torch.ones_like(bad))
    return torch.where(sel, sign * bad, ancestors.to(torch.int32))


def validate_ancestors(ancestors: torch.Tensor, n: int) -> torch.Tensor:
    """Range tripwire: every index must lie in ``[0, n)``.

    Returns ``ancestors`` unchanged when clean; raises the typed
    ``CorruptAncestorsError`` when any index is out of range.  It reads the
    result back to the host, so the chaos harness calls it, never the hot
    path."""
    bad = (ancestors < 0) | (ancestors >= n)
    count = int(bad.sum())
    if count:
        worst = ancestors[bad].reshape(-1)[:4].tolist()
        raise CorruptAncestorsError(
            f"ancestor vector holds {count} out-of-range indices (n={n}; e.g. {worst})")
    return ancestors


# ---------------------------------------------------------------- generators


def all_nan_bank(n: int, device="cuda") -> torch.Tensor:
    """``f32[n]`` log-weights, all NaN: every bit of information lost."""
    return torch.full((n,), float("nan"), dtype=torch.float32, device=resolve_device(device))


def all_neg_inf_bank(n: int, device="cuda") -> torch.Tensor:
    """``f32[n]`` log-weights, all ``-inf``: every particle impossible."""
    return torch.full((n,), float("-inf"), dtype=torch.float32, device=resolve_device(device))


def one_hot_bank(n: int, hot: int = 0, device="cuda") -> torch.Tensor:
    """All mass on one particle (``-inf`` elsewhere): not degenerate under
    the guard's predicate (its max is finite), but its ESS sits at 1/N."""
    out = all_neg_inf_bank(n, device)
    out[hot] = 0.0
    return out


def near_collapse_bank(n: int, scale: float = 80.0, device="cuda") -> torch.Tensor:
    """A steep finite geometric decay, ``-scale·i``: numerically near
    one-hot with no non-finite value; it runs the shift and ``exp`` at the
    edge of underflow."""
    dev = resolve_device(device)
    return (torch.tensor(-scale, dtype=torch.float32, device=dev)
            * torch.arange(n, dtype=torch.float32, device=dev))


#: name -> log-weight bank generator (``f32[n]``); the chaos suite's axis.
FAULT_CLASSES = {
    "all_nan": all_nan_bank,
    "all_neg_inf": all_neg_inf_bank,
    "one_hot": one_hot_bank,
    "near_collapse": near_collapse_bank,
}
