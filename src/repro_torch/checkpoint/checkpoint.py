"""Sharded npz checkpointing of training state: atomic, async, keep-last-k,
auto-resume.

Counterpart of ``repro.checkpoint.checkpoint`` with its layout and rules:

* every leaf is saved under its flattened path key: the parts of its path
  joined by ``/`` (a dict key, a list index, a NamedTuple field name), so
  ``{"params": ..., "opt": AdamWState(...)}`` gives ``params/embed``,
  ``params/blocks/0/l0/mixer/wq`` (the port keeps superblocks as a list,
  where the reference stacks them under ``params/blocks/l0/...``) and
  ``opt/step``, ``opt/m/...``;
* bfloat16 leaves are stored as float32 (an exact widening; ``np.savez``
  has no bfloat16) and cast back to the template's dtype on restore;
* every leaf is copied to the host before an async save is handed to its
  thread, so the training loop may update the tensors in place at once;
* writes go to ``<dir>/tmp.<step>.<host>`` then ``os.replace`` ->
  ``step_<08d>`` (atomic on POSIX: a crash mid-write never leaves a
  restorable step half written), ``shard<host>.npz`` plus ``meta.json``;
* ``keep`` bounds disk: older steps are deleted after a successful write;
* ``latest_step`` + ``restore`` implement crash auto-resume.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

# numpy dtypes np.savez stores as they are; others (bfloat16) go as float32
_NATIVE = (torch.float64, torch.float32, torch.float16, torch.int64, torch.int32, torch.int16,
           torch.int8, torch.uint8, torch.bool)


def _paths(tree, prefix=()):
    """(path parts, leaf) of every tensor of a nested dict / list / tuple /
    NamedTuple, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _paths(v, prefix + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (a copy even of a CPU tensor, which the loop may
    update in place while an async save writes)."""
    dtype = t.dtype if t.dtype in _NATIVE else torch.float32
    return t.detach().to(dtype).to("cpu", copy=True).numpy()


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {"/".join(path): _host(leaf) for path, leaf in _paths(tree)}


def _rebuild(template, it):
    if isinstance(template, dict):
        return {k: _rebuild(v, it) for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(v, it) for v in template))
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, it) for v in template)
    return next(it)


def _unflatten(template, flat: Dict[str, np.ndarray]):
    leaves = []
    for path, leaf in _paths(template):
        key = "/".join(path)
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape}, template {tuple(leaf.shape)}")
        host = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
        leaves.append(host.to(device=leaf.device).to(dtype=leaf.dtype))
    return _rebuild(template, iter(leaves))


def _host_index() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, metadata: Optional[dict] = None) -> None:
        host = _host_index()
        flat = _flatten(tree)  # on the host BEFORE the async handoff
        self.wait()
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, metadata or {}, host)
            )
            self._thread.start()
        else:
            self._write(step, flat, metadata or {}, host)

    def _write(self, step: int, flat, metadata, host: int) -> None:
        tmp = self.dir / f"tmp.{step}.{host}"
        final = self.dir / f"step_{step:08d}"
        tmp.mkdir(parents=True, exist_ok=True)
        np.savez(tmp / f"shard{host}.npz", **flat)
        with open(tmp / "meta.json", "w") as f:
            json.dump({"step": step, **metadata}, f)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ------------------------------------------------------------------
    def all_steps(self):
        return [
            int(p.name.split("_")[1])
            for p in self.dir.glob("step_*")
            if (p / "meta.json").exists()
        ]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return max(steps) if steps else None

    def restore(self, step: int, template: Any):
        """A new tree shaped as ``template``, each leaf in the template
        leaf's dtype and on its device."""
        path = self.dir / f"step_{step:08d}" / f"shard{_host_index()}.npz"
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        return _unflatten(template, flat)

    def metadata(self, step: int) -> dict:
        with open(self.dir / f"step_{step:08d}" / "meta.json") as f:
            return json.load(f)
