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

from repro_torch.tree import TreeDef, tree_flatten

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

    def save(self, step: int, tree, extra: Optional[Dict[str, Any]] = None
             ) -> Path:
        arrs, treedef = _flatten(tree)
        return self._write(step, arrs, treedef, extra)

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

    def restore(self, step: int, like_tree):
        """The checkpoint of ``step`` in the structure of ``like_tree``,
        each leaf cast to its template's dtype and put on its device."""
        path = self.dir / f"step_{step:08d}"
        leaves, treedef = tree_flatten(like_tree)
        with np.load(path / "arrays.npz") as data:
            if len(leaves) != len(data.files):
                raise ValueError(f"leaf count mismatch: checkpoint "
                                 f"{len(data.files)} vs {len(leaves)}")
            new_leaves = []
            for i, like in enumerate(leaves):
                arr = data[f"leaf_{i}"]
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
