"""Assigned input shapes (the 4 LM-transformer cells per architecture).

``train_*`` cells lower ``train_step``; ``decode_*`` / ``long_*`` lower
``serve_step`` (one new token against a KV cache of ``seq_len``);
``prefill_*`` lowers the prefill forward.  ``long_500k`` requires
sub-quadratic attention and is skipped for pure full-attention archs
(DESIGN.md §5), per the assignment.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"
    needs_subquadratic: bool = False


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode", needs_subquadratic=True),
}


def applicable_shapes(arch) -> list[str]:
    """Shape names this arch runs (long_500k only if sub-quadratic)."""
    out = []
    for name, s in SHAPES.items():
        if s.needs_subquadratic and not arch.model.long_context_ok:
            continue
        out.append(name)
    return out
