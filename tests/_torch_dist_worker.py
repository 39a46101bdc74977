"""One rank of the port's distributed Megopolis test
(``tests/test_torch_distributed.py``), started by ``torch.multiprocessing.spawn``:
a gloo process group over a ``FileStore`` (loopback sockets only), then the
static and dynamic resamplers, ``gather_ancestors``, ``island_exchange`` and
``effective_sample_size`` on this rank's block of weights made from a seed;
the results go to ``<out>/rank<r>.pt``."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def inputs(n: int):
    """The global weights and particles every rank slices its block from."""
    rng = np.random.default_rng(11)
    w = rng.gamma(0.5, size=n).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    return torch.from_numpy(w), torch.from_numpy(x)


def run(rank: int, world: int, store_path: str, out_dir: str, n: int, num_iters: int,
        key_data: list):
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.set_num_threads(1)
    from repro_torch.core import distributed as td
    from repro_torch.core.spec import MegopolisSpec

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        w, x = inputs(n)
        n_local = n // world
        block = slice(rank * n_local, (rank + 1) * n_local)
        key = torch.tensor(key_data, dtype=torch.int64)
        spec = MegopolisSpec(num_iters=num_iters, segment=td.DEFAULT_SEGMENT,
                             backend="reference")
        out = {}
        for schedule in ("static", "dynamic"):
            r = td.make_distributed_resampler(spec=spec, schedule=schedule)
            out[schedule] = r(key, w[block])
        out["gathered"] = td.gather_ancestors(x[block], out["static"])
        out["island"] = td.island_exchange(x[block], fraction=0.25)
        out["ess"] = td.effective_sample_size(w[block])
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
