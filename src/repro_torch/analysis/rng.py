"""RNG discipline (DESIGN.md §13, pass 3), after ``repro.analysis.rng``.

Parallel resamplers fail *silently* through RNG misuse: correlated streams
bias the resampled population without any crash.  The JAX pass reads the
random primitives of a jaxpr; the port records every key that
``repro_torch.random`` consumes (``split``, ``fold_in``, ``random_bits``,
through which ``uniform``, ``normal`` and ``randint`` go) and every key
that ``kernels.common.key_to_seed`` turns into a kernel's seed, while one
audited program runs, by value and with the program's call stack, and grades the
record:

  * **key-reuse**: one key value consumed twice by ``split``,
    ``random_bits`` or ``key_to_seed``, or by ``fold_in`` with equal data.  ``fold_in`` of
    distinct data is the documented idiom and is exempt.
  * **loop-invariant-key**: the same reuse, seen across iterations: every
    consumption of the key made by separate calls from the same call stack,
    one code path run again on an unchanged key, so every pass draws the
    same randoms.
  * **branch-drop**: the program run on both sides of its flag
    (``branch_findings``); a key consumed on one side and not on the other
    makes the stream's advance data-dependent (the §12 rule: the key is
    consumed in BOTH branches).

The record is scoped to one audited program, so ``PRNGKey(0)`` in two
separate programs is not reuse; a program that builds the same key twice
consumes it twice, and that is reuse.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Optional

from repro_torch.analysis.walker import Finding, program_stack


@dataclasses.dataclass(frozen=True)
class KeyEvent:
    """One key consumed: ``kind`` ``split``/``fold_in``/``random_bits``/``seed``, the
    key's two uint32 words, ``fold_in``'s data, the call that consumed it
    (a bank key's rows share one) and the call stack, innermost first
    (``walker.program_stack``)."""

    kind: str
    key: tuple
    data: Optional[int]
    call: int
    stack: tuple


class KeyLog:
    """The key observer of one recorded run (``random.observe_keys``)."""

    def __init__(self):
        self.events: list = []
        self._calls = itertools.count()

    def __call__(self, kind, key, data):
        call, stack = next(self._calls), program_stack()
        for k0, k1 in key.reshape(-1, 2).tolist():
            self.events.append(KeyEvent(kind, (k0, k1), data, call, stack))


def _is_violation(events) -> bool:
    """Two or more consumptions violate unless all are ``fold_in`` with
    distinct data."""
    if len(events) < 2:
        return False
    if any(e.kind != "fold_in" for e in events):
        return True
    return len({e.data for e in events}) < len(events)


def _key(words) -> str:
    return f"[{words[0]:#010x}, {words[1]:#010x}]"


def rng_findings(log: KeyLog) -> list:
    """key-reuse and loop-invariant-key findings of one recorded run."""
    by_key = collections.defaultdict(list)
    for e in log.events:
        by_key[e.key].append(e)
    findings = []
    for words, events in by_key.items():
        if not _is_violation(events):
            continue
        kinds = ", ".join(sorted(e.kind for e in events))
        looped = len({e.stack for e in events}) == 1 and len({e.call for e in events}) > 1
        if looped:
            findings.append(Finding(
                "rng", "loop-invariant-key", events[0].stack[0][0],
                f"loop-constant key {_key(words)} consumed by {events[0].kind} on every pass "
                "of the same code path — every iteration draws the same randoms"))
        else:
            findings.append(Finding(
                "rng", "key-reuse", ", ".join(sorted({e.stack[0][0] for e in events})),
                f"PRNG key {_key(words)} consumed by {len(events)} random primitives ({kinds})"))
    return findings


def branch_findings(one: KeyLog, other: KeyLog) -> list:
    """branch-drop findings of a program run on the two sides of its flag:
    one per key consumed on one side and not on the other."""
    sides = [collections.defaultdict(list) for _ in range(2)]
    for side, log in zip(sides, (one, other)):
        for e in log.events:
            side[e.key].append(e)
    findings = []
    for words in sorted(set(sides[0]) ^ set(sides[1])):
        events = sides[0].get(words) or sides[1][words]
        findings.append(Finding(
            "rng", "branch-drop", events[0].stack[0][0],
            f"key {_key(words)} consumed by {events[0].kind} on 1/2 sides of the flag and "
            "unused on the other — streams diverge across the branch"))
    return findings
