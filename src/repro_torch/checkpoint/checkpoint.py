"""Checkpointing: atomic save/restore in the reference's format — the
port of the reference's ``checkpoint/checkpoint.py``.

A checkpoint is the directory ``step_{N:08d}`` holding ``arrays.npz``
(the tree's leaves as ``leaf_{i}``, numbered in ``jax.tree_util``'s
flatten order, :mod:`repro_torch.tree`) and ``manifest.json`` (``step``,
``treedef``, ``n_leaves``, ``time``, ``extra``), so a checkpoint either
package writes restores in the other.  Contract (``launch/train.py``):

* saves are atomic (written to a temporary directory, then renamed) — a
  crash mid-save never corrupts the latest checkpoint;
* ``latest_step`` + ``restore`` implement crash-restart;
* ``restore`` loads full logical arrays into the structure, dtype and
  device of a template tree;
* an optional ``keep`` window garbage-collects old steps.

A leaf numpy cannot hold (bfloat16: this package does not depend on
``ml_dtypes``) is refused rather than written in a form the reference
could not read; training masters are float32, the reference's default.

A mesh's state (each rank's shards of ``{"params": ..., "opt":
OptState(step, m, v)}``, :func:`repro_torch.core.steps.
build_train_step`) is saved with ``shard=(plan, env)``: every rank
calls :meth:`CheckpointManager.save`, each leaf is gathered to the
plan's global tensor (:func:`repro_torch.weights.gather_leaf`) and
rank 0 writes them, so the files are the ones the reference writes for
that plan.  :meth:`CheckpointManager.restore` with ``shard=(plan,
rank)`` cuts each global array to the rank's slice of any mesh of the
same layout (elastic restart: another data width at the same tp).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import TreeDef, tree_flatten, tree_paths

_STEP_DIR = re.compile(r"step_(\d+)$")


def _host(i: int, x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError(
                f"leaf_{i}: a bfloat16 tensor has no numpy dtype the "
                "reference could read; checkpoint float32 masters")
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten(tree) -> Tuple[Dict[str, np.ndarray], TreeDef]:
    leaves, treedef = tree_flatten(tree)
    return {f"leaf_{i}": _host(i, x) for i, x in enumerate(leaves)}, treedef


def param_path(path: str) -> Optional[str]:
    """The parameter path a train state's leaf is laid out as:
    ``params/<p>``, ``opt/m/<p>`` and ``opt/v/<p>`` are ``<p>``; any
    other leaf (``opt/step``) is replicated (None)."""
    parts = path.split("/")
    if parts[0] == "params" and len(parts) > 1:
        return "/".join(parts[1:])
    if parts[:2] in (["opt", "m"], ["opt", "v"]) and len(parts) > 2:
        return "/".join(parts[2:])
    return None


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._async_thread: Optional[threading.Thread] = None

    # -- core ---------------------------------------------------------------

    def _write(self, step: int, arrs: Dict[str, np.ndarray],
               treedef: TreeDef, extra: Optional[Dict[str, Any]]) -> Path:
        final = self.dir / f"step_{step:08d}"
        tmp = Path(tempfile.mkdtemp(dir=self.dir, prefix=".tmp_save_"))
        np.savez(tmp / "arrays.npz", **arrs)
        manifest = {
            "step": step,
            "treedef": repr(treedef),
            "n_leaves": len(arrs),
            "time": time.time(),
            "extra": extra or {},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)                       # atomic publish
        self._gc()
        return final

    def save(self, step: int, tree, extra: Optional[Dict[str, Any]] = None,
             shard=None) -> Optional[Path]:
        """Write ``tree`` as step ``step``.  ``shard=(plan, env)``: the
        tree holds this rank's shards of a mesh's train state; every
        rank calls this, each leaf is gathered to the plan's global
        tensor in flatten order, and world rank 0 writes them (the
        others return None)."""
        if shard is None:
            arrs, treedef = _flatten(tree)
            return self._write(step, arrs, treedef, extra)
        from repro_torch.weights import gather_leaf
        plan, env = shard
        writer = env.world is None or env.world.rank == 0
        leaves, treedef = tree_flatten(tree)
        arrs = {}
        for i, (x, path) in enumerate(zip(leaves, tree_paths(tree))):
            pp = param_path(path)
            if pp is not None:
                x = gather_leaf(x, pp, plan, env)
            if writer:
                arrs[f"leaf_{i}"] = _host(i, x)
        return self._write(step, arrs, treedef, extra) if writer else None

    def save_async(self, step: int, tree,
                   extra: Optional[Dict[str, Any]] = None) -> None:
        """Non-blocking save: the leaves are copied to the host before
        it returns, the files are written by a thread (:meth:`wait`)."""
        arrs, treedef = _flatten(tree)              # device->host copy here
        self.wait()
        self._async_thread = threading.Thread(
            target=self._write, args=(step, arrs, treedef, extra),
            daemon=True)
        self._async_thread.start()

    def wait(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    def latest_step(self) -> Optional[int]:
        steps = []
        for p in self.dir.glob("step_*"):
            m = _STEP_DIR.match(p.name)
            if m and (p / "manifest.json").exists():
                steps.append(int(m.group(1)))
        return max(steps) if steps else None

    def restore(self, step: int, like_tree, shard=None):
        """The checkpoint of ``step`` in the structure of ``like_tree``,
        each leaf cast to its template's dtype and put on its device.
        ``shard=(plan, rank)``: ``like_tree`` holds a mesh rank's shards
        of a train state, and each global array is cut to world rank
        ``rank``'s slice at ``plan`` first (any data width of the
        layout the checkpoint was written at)."""
        from repro_torch.weights import shard_leaf
        path = self.dir / f"step_{step:08d}"
        leaves, treedef = tree_flatten(like_tree)
        paths = tree_paths(like_tree)
        with np.load(path / "arrays.npz") as data:
            if len(leaves) != len(data.files):
                raise ValueError(f"leaf count mismatch: checkpoint "
                                 f"{len(data.files)} vs {len(leaves)}")
            new_leaves = []
            for i, like in enumerate(leaves):
                arr = data[f"leaf_{i}"]
                pp = param_path(paths[i]) if shard is not None else None
                if pp is not None:
                    arr = shard_leaf(arr, pp, shard[0], int(shard[1]))
                if arr.shape != tuple(like.shape):
                    raise ValueError(f"leaf_{i}: checkpoint shape "
                                     f"{arr.shape}, template "
                                     f"{tuple(like.shape)}")
                new_leaves.append(torch.from_numpy(arr).to(
                    device=like.device, dtype=like.dtype))
        return treedef.unflatten(new_leaves)

    def manifest(self, step: int) -> Dict[str, Any]:
        return json.loads(
            (self.dir / f"step_{step:08d}" / "manifest.json").read_text())

    def _gc(self) -> None:
        steps = sorted(int(m.group(1)) for m in
                       (_STEP_DIR.match(p.name)
                        for p in self.dir.glob("step_*")) if m)
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
