"""Crash-consistent long runs: a checkpointed scan (DESIGN.md §16), after
``repro.resilience.checkpointing``.

The port's filter and sampler are Python loops of eager steps where the
JAX package runs a ``lax.scan``; ``scan(body, init, xs)`` is that loop
(``body(carry, x) -> (carry, ys)``, the per-step ``ys`` stacked along a new
leading axis), and ``checkpointed_scan`` runs the same loop in chunks of
``CheckpointPolicy.every`` steps.  After each chunk it copies ``{carry, ys
so far}`` to the host (which waits for the card) and persists it
atomically through ``repro_torch.checkpoint`` (a temporary directory,
fsync, rename: a crash mid-save never corrupts the previous snapshot).  The carry is everything a
step reads (for the filter its particles, log-weights and key; for AIS also
the evidence, β, the step sizes and the resample count), so a resume
restores the last durable carry and ``ys`` prefix and continues the same
loop from there: each later step runs the same ops on the same bits, and
the result is the uninterrupted run's, bit for bit.

``fail_after`` is the kill switch of the kill-and-resume tests: the run
raises ``InjectedCrash`` in the chunk that crosses that step, strictly
AFTER its snapshot is durable, so a resumed run never crashes again.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    tree_leaves_with_paths,
    unflatten,
)
from repro_torch.resilience.errors import InjectedCrash


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    """Where and how often a long run snapshots its carry.

    ``directory``   snapshot root (``repro_torch.checkpoint``'s layout).
    ``every``       snapshot period, in steps (the chunk length).
    ``keep``        snapshots kept (older ones deleted after a newer save
                    completes: one is always restorable).
    ``resume``      pick up from the latest durable snapshot when there is
                    one (else start clean).
    ``fail_after``  chaos hook: raise ``InjectedCrash`` once the run crosses
                    this step, AFTER that snapshot is durable; None disables.
    """

    directory: str
    every: int = 1
    keep: int = 3
    resume: bool = True
    fail_after: Optional[int] = None

    def __post_init__(self):
        if not self.directory:
            raise ValueError("CheckpointPolicy.directory must be non-empty")
        if isinstance(self.every, bool) or not isinstance(self.every, int) or self.every < 1:
            raise ValueError(
                f"CheckpointPolicy.every must be a positive int; got {self.every!r}"
            )


def check_policy(policy, who: str) -> None:
    """Raise ``TypeError`` unless ``policy`` is None or a ``CheckpointPolicy``
    (an entry checks it before any work)."""
    if policy is not None and not isinstance(policy, CheckpointPolicy):
        raise TypeError(f"{who}: checkpoint must be a CheckpointPolicy or None; "
                        f"got {type(policy).__name__}")


def _length(xs) -> int:
    if isinstance(xs, int):
        return xs
    leaves = xs if isinstance(xs, (tuple, list)) else (xs,)
    if not leaves:
        raise ValueError("checkpointed_scan: xs must carry at least one tensor")
    return leaves[0].shape[0]


def _step_inputs(xs, t: int):
    if isinstance(xs, int):
        return t
    if isinstance(xs, (tuple, list)):
        return type(xs)(x[t] for x in xs)
    return xs[t]


def _run(body, carry, xs, t0: int, t1: int):
    """Steps ``t0 .. t1 - 1``: ``(carry, [ys per step])``."""
    ys = []
    for t in range(t0, t1):
        carry, y = body(carry, _step_inputs(xs, t))
        ys.append(tuple(y))
    return carry, ys


def _stacked(ys: list) -> tuple:
    return tuple(torch.stack(field) for field in zip(*ys))


def scan(body, init, xs):
    """The monolithic loop: ``body(carry, x)`` over the leading axis of
    ``xs`` (a tensor, a tuple of tensors, or a step count), each step's
    ``ys`` a tuple of tensors; returns ``(carry, ys)`` with each ``ys``
    field stacked along a new leading axis (an empty tuple for no steps)."""
    carry, ys = _run(body, init, xs, 0, _length(xs))
    return carry, _stacked(ys)


def checkpointed_scan(body, init, xs, policy: Optional[CheckpointPolicy]):
    """``scan(body, init, xs)`` with durable snapshots every
    ``policy.every`` steps; ``policy=None`` is ``scan`` itself.  The
    returned ``(carry, ys)`` is the monolithic loop's, bit for bit, whether
    or not the run resumed from a snapshot."""
    if policy is None:
        return scan(body, init, xs)
    check_policy(policy, "checkpointed_scan")
    length = _length(xs)
    start, carry, head = 0, init, None
    if policy.resume:
        step = latest_step(policy.directory)
        if step is not None:
            snap, manifest = restore_checkpoint(policy.directory, step)
            start = min(int(step), length)
            carry = unflatten(snap, init, "carry")
            fields = manifest["extra"].get("ys_fields", 0)
            if start and fields:
                dev = next((x.device for _, x in tree_leaves_with_paths(init)
                            if isinstance(x, torch.Tensor)), None)
                head = tuple(snap[f"ys/{i}"].to(dev) for i in range(fields))

    mgr = CheckpointManager(policy.directory, keep=policy.keep)
    parts = [] if head is None else [head]
    for t0 in range(start, length, policy.every):
        t1 = min(t0 + policy.every, length)
        carry, ys = _run(body, carry, xs, t0, t1)
        parts.append(_stacked(ys))
        done = tuple(torch.cat(f) for f in zip(*parts))
        parts = [done]
        mgr.save(t1, {"carry": carry, "ys": done},
                 extra={"t_done": t1, "length": length, "ys_fields": len(done)})
        if policy.fail_after is not None and t0 < policy.fail_after <= t1:
            raise InjectedCrash(f"injected crash after the durable snapshot at step {t1} "
                                f"(fail_after={policy.fail_after})")
    if not parts:
        return carry, ()
    return carry, parts[0]
