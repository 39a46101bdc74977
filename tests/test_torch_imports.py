"""The port stands alone: no file of ``src/repro_torch``, ``chip_smoke.py``
nor the port's ``benchmarks/torch_*.py`` imports ``jax`` or the JAX package ``repro``, and importing the port leaves
``jax`` out of ``sys.modules``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = (sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
              + sorted((REPO / "benchmarks").glob("torch_*.py")))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    mods = ["repro_torch.pf.filter", "repro_torch.pf.models", "repro_torch.convert",
            "repro_torch.kernels.megopolis.ops", "repro_torch.kernels.metropolis.ops",
            "repro_torch.kernels.rejection.ops", "repro_torch.kernels.prefix_sum.ops",
            "repro_torch.kernels.build", "repro_torch.analysis", "repro_torch.ais",
            "repro_torch.configs", "repro_torch.models", "repro_torch.smc",
            "repro_torch.launch.serve"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods) +
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Without a card, or without the repo around it, the smoke exits
    non-zero and prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text(encoding="utf-8"))
    out = subprocess.run([sys.executable, str(lone)], capture_output=True, text=True,
                         cwd=tmp_path, timeout=120, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
