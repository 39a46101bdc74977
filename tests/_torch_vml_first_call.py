"""Is PyTorch's first CPU ``exp`` exact when its first call is threaded?

PyTorch sends a contiguous float32 ``exp`` on the CPU to MKL's VML in
chunks of 2048 elements, one per OpenMP thread.  This script starts fresh
processes that each dispatch a JAX Pallas step kernel (interpret mode, so
XLA's CPU threads are busy) and then, while it runs, take their first
``exp`` of 4096 weights, and compare it bit for bit with a second call of
the same ``exp``.  Arm ``cold`` makes that threaded call first; arm
``setup`` first runs ``exp`` and ``log`` on one element, as importing
``repro_torch`` does.  It prints, per arm, the processes whose first call
differed, the elements that differed and the largest relative error.

    PYTHONPATH=src python tests/_torch_vml_first_call.py --runs 200 --jobs 6
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

CHILD = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
import torch
from repro.kernels.metropolis import metropolis as jk

if sys.argv[1] == "setup":
    torch.exp(torch.zeros(1))
    torch.log(torch.ones(1))
n = 4096
lw = (np.random.default_rng(0).normal(size=n) * 3).astype(np.float32)
out = jk.metropolis_pallas_step(
    jnp.asarray(lw.reshape(-1, 128)), jnp.zeros((1, n // 128, 128)),
    jnp.asarray(np.array([7], np.uint32)), jnp.float32([0.0]), num_iters=8, interpret=True)
x = torch.from_numpy(lw - lw.max())
first = torch.exp(x)
jax.block_until_ready(out)
again = torch.exp(x)
bad = first != again
rel = ((first - again).abs() / again).max().item() if bool(bad.any()) else 0.0
print(json.dumps({"elements": int(bad.sum()), "max_rel": rel}))
"""


def run_one(arm: str) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD, arm], capture_output=True, text=True,
                         timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=100, help="processes per arm")
    ap.add_argument("--jobs", type=int, default=4, help="processes at a time")
    args = ap.parse_args(argv)
    arms = ["cold", "setup"] * args.runs
    with ThreadPoolExecutor(args.jobs) as pool:
        results = list(pool.map(run_one, arms))
    for arm in ("cold", "setup"):
        mine = [r for a, r in zip(arms, results) if a == arm]
        bad = [r for r in mine if r["elements"]]
        print(json.dumps({"arm": arm, "processes": len(mine), "first_call_differed": len(bad),
                          "elements_max": max((r["elements"] for r in bad), default=0),
                          "max_rel": max((r["max_rel"] for r in bad), default=0.0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
