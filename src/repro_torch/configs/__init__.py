"""Architecture registry, after ``repro.configs``: the 10 assigned archs and
the paper's own particle-filter config.

Each ``<id>.py`` exports an ``ArchSpec`` named ``ARCH`` with the exact
published configuration (``model``, FULL) and a reduced same-family
``smoke`` variant, every field equal to the JAX package's (``dtype`` as the
torch dtype).  Every arch runs on the port's ``models/``: the dense ones,
the MoE ones (dbrx, llama4: ``models/moe.py``) and the SSM and hybrid ones
(mamba2, zamba2: ``models/mamba2.py``).
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable_shapes  # noqa: F401
from repro_torch.models import ModelConfig


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str  # dense | moe | audio | vlm | hybrid | ssm
    model: ModelConfig
    smoke: ModelConfig
    source: str
    # train_4k memory knobs (per-cell overrides keyed by shape name)
    microbatches: int = 1
    moment_dtype: str = "float32"  # bf16 moments for archs that need the memory
    notes: str = ""


ARCH_IDS = (
    "nemotron_4_15b",
    "gemma3_27b",
    "h2o_danube_3_4b",
    "qwen3_0_6b",
    "dbrx_132b",
    "llama4_maverick_400b_a17b",
    "musicgen_large",
    "chameleon_34b",
    "zamba2_2_7b",
    "mamba2_1_3b",
)


def _norm(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


_ALIASES = {_norm(i): i for i in ARCH_IDS}


def get_arch(name: str) -> ArchSpec:
    """The ``ArchSpec`` of an arch id or its published name
    (``"qwen3-0.6b"`` and ``"qwen3_0_6b"`` alike)."""
    key = _ALIASES.get(_norm(name), name)
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; choices: {list(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{key}").ARCH


def list_archs() -> list[str]:
    return list(ARCH_IDS)
