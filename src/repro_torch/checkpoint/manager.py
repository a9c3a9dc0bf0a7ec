"""Checkpoint manager with the paper's indicator discipline lifted to storage.

Port of ``repro.checkpoint.manager``, the same protocol and the same files.
Continuity hashing's crash consistency rule (write the payload first, then
flip the indicator with ONE atomic store) becomes, at checkpoint scale:

  1. write every payload ``.npy`` under ``step_N.tmp/`` and fsync each;
  2. write ``MANIFEST.json`` (the "indicator") listing each payload's
     shape, dtype and sha256[:16] digest;
  3. atomically ``rename(step_N.tmp, step_N)``: the single commit.

A crash before (3) leaves a .tmp directory that restart ignores; after it
the checkpoint is complete.  ``save`` copies the tree to the host (the only
part the train loop waits for) and commits on a background thread;
``restore`` picks the newest committed step and checks every digest;
``keep`` bounds the committed steps kept.

Leaves are named as the reference's jax-path flattening names them, built
here without jax: dict keys sorted, NamedTuple fields by name, sequence
items by index, joined by "." (``p.blocks.wq``, ``o.m.embed``,
``o.step``), so a checkpoint written by either package restores in the
other.  Restored leaves are tensors on the template leaf's device, in the
checkpoint's dtype.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch


def _items(tree, prefix=()):
    """(path, leaf) pairs in the reference's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _items(getattr(tree, name), prefix + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _flatten(tree) -> dict:
    """Canonical {dotted-path: leaf} mapping."""
    return {".".join(path) or "_root": leaf for path, leaf in _items(tree)}


def _unflatten(template, arrays: dict, prefix=()):
    """``template``'s structure with each leaf the tensor of its path, on
    the template leaf's device."""
    if isinstance(template, dict):
        return {k: _unflatten(v, arrays, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten(getattr(template, n), arrays,
                                           prefix + (n,))
                                for n in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, arrays, prefix + (str(i),))
                              for i, v in enumerate(template))
    dev = template.device if isinstance(template, torch.Tensor) else "cpu"
    # a tensor of torch's own allocation, as the leaf it replaces (not a
    # view of the loaded array)
    return torch.from_numpy(arrays[".".join(prefix) or "_root"]).to(
        dev, copy=True)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("bfloat16 leaves have no numpy dtype: "
                            "checkpoint the float32 masters")
        # a copy even from the CPU: the optimizer updates leaves in place
        # while the commit thread writes them
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        """Snapshot to host, then commit (optionally) in the background."""
        host = {k: _host(v) for k, v in _flatten(tree).items()}  # D2H
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._commit, args=(step, host, extra or {}),
                daemon=True)
            self._thread.start()
        else:
            self._commit(step, host, extra or {})

    def _commit(self, step: int, host: dict, extra: dict):
        tmp = os.path.join(self.dir, f"step_{step:09d}.tmp")
        final = os.path.join(self.dir, f"step_{step:09d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra, "arrays": {}}
        for k, v in host.items():
            path = os.path.join(tmp, k.replace("/", "_") + ".npy")
            with open(path, "wb") as f:                 # phase 1: payloads
                np.save(f, v)
                f.flush()
                os.fsync(f.fileno())
            manifest["arrays"][k] = {
                "file": os.path.basename(path), "shape": list(v.shape),
                "dtype": str(v.dtype), "digest": _digest(v)}
        mpath = os.path.join(tmp, "MANIFEST.json")
        with open(mpath, "w") as f:                     # phase 2: indicator
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                           # atomic commit
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.committed_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def committed_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):                   # uncommitted: invisible
                continue
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "MANIFEST.json")):
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None):
        """Restore into the structure of ``template``; verifies digests.
        Returns (tree, step, extra) or (None, None, None) if no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None, None
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        arrays = {}
        for k, meta in manifest["arrays"].items():
            v = np.load(os.path.join(d, meta["file"]))
            if _digest(v) != meta["digest"]:
                raise IOError(f"digest mismatch for {k} in step {step}")
            arrays[k] = v
        missing = set(_flatten(template)) - set(arrays)
        if missing:
            raise KeyError(f"checkpoint step {step} missing "
                           f"{sorted(missing)[:5]}")
        return _unflatten(template, arrays), step, manifest["extra"]
