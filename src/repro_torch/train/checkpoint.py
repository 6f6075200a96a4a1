"""Fault-tolerant checkpointing: atomic, async, resumable.

Counterpart of ``repro.train.checkpoint``, with the same directory protocol:

    <dir>/step_<n>/arrays.npz     the leaves, keyed by their path
    <dir>/step_<n>/meta.json      the paths, the dtypes numpy lacks, extra state
    <dir>/LATEST                  pointer file (written last -> atomic commit)

A leaf's key is its path in the tree (``params/blocks/0/attn/wq``,
``opt/m/embed``, ``opt/step``: dict keys, list indices and a NamedTuple's
field names joined by ``/``), not a JAX treedef.  A bfloat16 tensor is
stored widened to float32 (exact) and its dtype kept in ``meta.json``, so a
restore is bit for bit.  Crash-safety: a checkpoint directory is written
under a temp name and renamed (rename is atomic on POSIX); LATEST is
updated only after the rename, so a crash mid-write can never corrupt the
restore path.  :class:`AsyncCheckpointer` copies the leaves to host memory
synchronously and writes them from a thread (blocking only on the previous
write).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.model import tensor_to_numpy


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) of every leaf: tensors, numpy arrays and numbers."""
    if hasattr(tree, "_fields"):  # a NamedTuple: its fields by name
        items = [(name, getattr(tree, name)) for name in tree._fields]
    elif isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(prefix[:-1], tree)]
    return [leaf for k, v in items for leaf in _flatten(v, f"{prefix}{k}/")]


def _unflatten(tree_like: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
    if hasattr(tree_like, "_fields"):
        return type(tree_like)(*[_unflatten(getattr(tree_like, name), leaves, f"{prefix}{name}/")
                                 for name in tree_like._fields])
    if isinstance(tree_like, dict):
        return {k: _unflatten(v, leaves, f"{prefix}{k}/") for k, v in tree_like.items()}
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(_unflatten(v, leaves, f"{prefix}{i}/")
                               for i, v in enumerate(tree_like))
    return leaves[prefix[:-1]]


def _to_host(tree: Any) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Every leaf as a numpy copy, and the dtype of each bfloat16 leaf."""
    arrays, dtypes = {}, {}
    for path, x in _flatten(tree):
        if isinstance(x, torch.Tensor):
            if x.dtype == torch.bfloat16:
                dtypes[path] = "bfloat16"
            arrays[path] = tensor_to_numpy(x).copy()
        else:
            arrays[path] = np.array(x)
    return arrays, dtypes


def _write(directory: str, step: int, arrays: Dict[str, np.ndarray], dtypes: Dict[str, str],
           extra: Optional[Dict]) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    meta = {"step": step, "n_leaves": len(arrays), "paths": list(arrays), "dtypes": dtypes,
            "extra": extra or {}}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(os.path.basename(final))
    os.replace(os.path.join(directory, "LATEST.tmp"), os.path.join(directory, "LATEST"))
    return final


def save_checkpoint(directory: str, step: int, tree: Any, extra: Optional[Dict] = None) -> str:
    arrays, dtypes = _to_host(tree)
    return _write(directory, step, arrays, dtypes, extra)


def latest_step(directory: str) -> Optional[int]:
    try:
        with open(os.path.join(directory, "LATEST")) as f:
            name = f.read().strip()
        return int(name.split("_")[-1])
    except (FileNotFoundError, ValueError):
        return None


def restore_checkpoint(directory: str, tree_like: Any,
                       step: Optional[int] = None) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``tree_like``: each tensor leaf on its
    like's device in its dtype (requiring grad where the like does), each
    number as its like's type.  Returns (tree, step, extra)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    likes = _flatten(tree_like)
    want = [p for p, _ in likes]
    if sorted(meta["paths"]) != sorted(want):
        missing = sorted(set(want) - set(meta["paths"]))
        raise ValueError(f"checkpoint has {meta['n_leaves']} leaves, expected {len(want)}; "
                         f"missing {missing[:5]}")
    leaves = {}
    for p, like in likes:
        arr = data[p]
        if isinstance(like, torch.Tensor):
            t = torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)
            leaves[p] = t.requires_grad_(like.requires_grad)
        else:
            leaves[p] = type(like)(arr.item()) if np.ndim(arr) == 0 else arr
    return _unflatten(tree_like, leaves), step, meta.get("extra", {})


class AsyncCheckpointer:
    """Overlap checkpoint writes with training; keep_last pruning included."""

    def __init__(self, directory: str, keep_last: int = 3):
        self.directory = directory
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> None:
        self.wait()  # one write in flight at a time
        arrays, dtypes = _to_host(tree)  # snapshot to host memory synchronously, write async

        def _run():
            try:
                _write(self.directory, step, arrays, dtypes, extra)
                self._prune()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def _prune(self) -> None:
        steps = sorted(
            int(d.split("_")[-1])
            for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp")
        )
        for s in steps[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)
