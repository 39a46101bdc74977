"""Atomic, async checkpointing of tensor trees, after
``repro.checkpoint.checkpoint`` (the part the resilience layer needs).

Layout (one directory per step)::

    ckpt_dir/
      step_00000100/
        manifest.json       # step, leaf paths, shapes, dtypes, wall time, extra
        arrays.npz          # the leaves as numpy arrays, keyed by tree path
      step_00000200/ ...
      LATEST                # text file: the last COMPLETE step directory

Atomicity: write into ``<dir>.tmp``, fsync, ``os.rename`` (atomic on POSIX),
then replace ``LATEST`` the same way: a crash mid-save never corrupts the
previous checkpoint and never leaves a half checkpoint visible.

A tree is nested dicts, lists and tuples (named tuples too) of tensors,
numpy arrays or Python numbers; ``None`` holds no leaf.  A leaf's path is
its keys and indices joined by ``/`` (``carry/0``, ``ys/3``): the port's
own naming, in place of the JAX package's ``keystr_simple``.  Tensors go to
the host as numpy arrays (a bfloat16 tensor as its 16-bit patterns, its
dtype in the manifest); ``restore_checkpoint(template=)`` puts each leaf
back on its template leaf's device in its dtype.

Async: ``CheckpointManager.save_async`` copies the leaves to host memory
first (the only part that waits on the card), then a daemon thread writes
and fsyncs while the run goes on; ``wait()`` joins, and is called before
the next save.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

import numpy as np
import torch


def tree_leaves_with_paths(tree, prefix: str = "") -> list:
    """``[(path, leaf)]`` of a tree in order (a dict's keys sorted, as JAX
    flattens them)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for name, child in items:
        out += tree_leaves_with_paths(child, f"{prefix}/{name}" if prefix else name)
    return out


def tree_leaves(tree) -> list:
    """The leaves of a tree in ``tree_leaves_with_paths``'s order."""
    return [leaf for _, leaf in tree_leaves_with_paths(tree)]


def tree_unflatten(template, leaves):
    """A tree shaped as ``template`` whose leaves are ``leaves``, in
    ``tree_leaves``'s order (``jax.tree.unflatten``'s counterpart)."""
    return _rebuild(template, iter(leaves))


def _rebuild(template, leaves):
    """A tree shaped as ``template`` whose leaves are taken in order from the
    iterator ``leaves``."""
    if template is None:
        return None
    if isinstance(template, dict):
        built = {k: _rebuild(template[k], leaves) for k in sorted(template)}
        return {k: built[k] for k in template}
    if isinstance(template, (list, tuple)):
        children = [_rebuild(v, leaves) for v in template]
        if hasattr(template, "_fields"):  # a named tuple
            return type(template)(*children)
        return type(template)(children)
    return next(leaves)


def _to_host(leaf) -> tuple:
    """``(numpy array, dtype name)`` of a leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.cpu().numpy(), name
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr))
    return t.view(torch.bfloat16) if dtype_name == "bfloat16" else t


def _host_items(tree) -> tuple:
    host, dtypes = {}, {}
    for path, leaf in tree_leaves_with_paths(tree):
        host[path], dtypes[path] = _to_host(leaf)
    return host, dtypes


def _fsync_write(path: str, text: str):
    with open(path, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())


def _save_host(ckpt_dir: str, step: int, host: dict, dtypes: dict,
               extra: Optional[dict]) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
        np.savez(f, **host)
        f.flush()
        os.fsync(f.fileno())
    manifest = {
        "step": int(step),
        "keys": sorted(host),
        "shapes": {k: list(v.shape) for k, v in host.items()},
        "dtypes": dtypes,
        "saved_unix_time": time.time(),
        "extra": extra or {},
    }
    _fsync_write(os.path.join(tmp, "manifest.json"), json.dumps(manifest, indent=1))
    if os.path.exists(final):  # a step saved again
        os.rename(final, final + f".old.{int(time.time() * 1e6)}")
    os.rename(tmp, final)
    _fsync_write(os.path.join(ckpt_dir, "LATEST.tmp"), os.path.basename(final))
    os.rename(os.path.join(ckpt_dir, "LATEST.tmp"), os.path.join(ckpt_dir, "LATEST"))
    return final


def save_checkpoint(ckpt_dir: str, step: int, tree, *, extra: Optional[dict] = None) -> str:
    """Synchronous atomic save; returns the checkpoint's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    return _save_host(ckpt_dir, step, *_host_items(tree), extra)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The step of the last complete checkpoint, or None."""
    marker = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[-1])


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None, *, template=None):
    """``(tree or {path: tensor}, manifest)`` of a checkpoint (the latest by
    default).  With ``template`` (a tree of tensors shaped as the saved
    one) the leaves come back in its structure, each on its template
    leaf's device and in its dtype; without, a flat dict of CPU tensors."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        host = {k: _to_tensor(z[k], manifest["dtypes"][k]) for k in z.files}
    if template is None:
        return host, manifest
    return unflatten(host, template), manifest


def unflatten(flat: dict, template, prefix: str = ""):
    """The leaves of ``flat`` (``{path: tensor}``, as a restore without a
    template gives it) under ``prefix`` in ``template``'s structure, each
    on its template leaf's device and in its dtype."""
    leaves = []
    for key, tmpl in tree_leaves_with_paths(template, prefix):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        t = flat[key]
        if tuple(t.shape) != tuple(tmpl.shape):
            raise ValueError(f"shape mismatch for {key}: checkpoint {tuple(t.shape)}, "
                             f"template {tuple(tmpl.shape)}")
        if isinstance(tmpl, torch.Tensor):
            t = t.to(device=tmpl.device, dtype=tmpl.dtype)
        leaves.append(t)
    return _rebuild(template, iter(leaves))


class CheckpointManager:
    """Async writer with retention.

    One save in flight at a time (``save_async`` joins the previous one
    first).  The ``keep`` most recent checkpoints are kept; older ones are
    deleted only AFTER a newer save is complete, so a restorable checkpoint
    is always on disk."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        os.makedirs(ckpt_dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree, *, extra: Optional[dict] = None):
        self.wait()
        host, dtypes = _host_items(tree)  # on the host NOW: the run may overwrite the tensors

        def work():
            try:
                _save_host(self.ckpt_dir, step, host, dtypes, extra)
                self._gc()
            except BaseException as e:  # raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save(self, step: int, tree, *, extra: Optional[dict] = None) -> str:
        self.wait()
        path = save_checkpoint(self.ckpt_dir, step, tree, extra=extra)
        self._gc()
        return path

    def _gc(self):
        steps = sorted(
            d for d in os.listdir(self.ckpt_dir)
            if d.startswith("step_") and not d.endswith(".tmp") and ".old." not in d
        )
        for stale in steps[: -self.keep] if self.keep > 0 else []:
            full = os.path.join(self.ckpt_dir, stale)
            for root, dirs, files in os.walk(full, topdown=False):
                for f in files:
                    os.unlink(os.path.join(root, f))
                for d in dirs:
                    os.rmdir(os.path.join(root, d))
            os.rmdir(full)
