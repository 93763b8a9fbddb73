"""Versioned snapshots of a :class:`repro_torch.index.SpatialIndex`.

Counterpart of ``repro.checkpoint.spatial``, in the same on-disk format,
so a snapshot written by either package loads in the other.  One snapshot
is one directory, published atomically::

    <path>/
      meta.json     format version, structure, build opts, schedule statics,
                    merge-policy fields, admission mode, array manifest
      arrays.npz    base object table + LevelSchedule arrays
                    (+ the uint16 tile arrays when they were made)
                    (+ the UpdateLog's delta/tombstone/id-space arrays when
                    live-update state exists)

Arrays are copied to the host (``.cpu().numpy()``) under the reference's
key names and dtypes.  The write goes to ``<path>.tmp-<pid>`` and lands
with ``os.replace`` — a crash mid-save leaves either the previous snapshot
or none, never a torn one.  Beyond the reference's fsyncs (``meta.json``
and both directories) the port also fsyncs ``arrays.npz`` before the
publish, so the published arrays survive a power loss too.

Loading installs the saved :class:`LevelSchedule` (and uint16 tiles) on the
requested device as they are (:meth:`BuildArtifacts.restore`): no build and
no quantization runs, so a load launches neither kernel #4 nor #5 and an
index saved from a healthy card reopens on any backend with the same hits
and visits.  The snapshot captures *state*, not *history*: pair it with
the mutation WAL (:class:`repro_torch.checkpoint.DurableIndex`) for crash
consistency between snapshots.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.obs import trace as _obs_trace

FORMAT_VERSION = 1

_SCHED_KEYS = (
    "mbr_cm", "parent", "n_real", "obj_mbr", "obj_level", "obj_slot", "obj_id",
)
_QUANT_KEYS = ("mbr_q", "parent_q", "origin", "inv_cell", "confirm_mbr")


class SnapshotError(RuntimeError):
    """The snapshot is unreadable or from an unknown format version."""


def _json_safe(d: dict) -> dict:
    out = {}
    for k, v in (d or {}).items():
        if isinstance(v, tuple):
            v = list(v)
        try:
            json.dumps(v)
        except TypeError:
            continue  # non-serializable opt (e.g. a FaultPlan): not state
        out[k] = v
    return out


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def index_state(idx) -> Tuple[dict, dict]:
    """``(meta, arrays)`` snapshot content for ``idx`` — the CURRENT base
    build plus any live-update state, arrays on the host."""
    art = idx.artifacts  # current base: post-merge artifacts once mutated
    sched = art.schedule
    meta = {
        "format_version": FORMAT_VERSION,
        "structure": art.structure,
        "build_opts": _json_safe(art.build_opts),
        "backend": idx.backend,
        "backend_opts": _json_safe(idx._backend_opts),
        "admission": idx._admission,
        "schedule": {
            "n_objects": int(sched.n_objects),
            "root_unconditional": bool(sched.root_unconditional),
            "test_object_mbr": bool(sched.test_object_mbr),
        },
        "has_quantized": art._quantized is not None,
        "has_updates": idx._updates is not None,
    }
    arrays = {"mbrs": art.mbrs}
    for k in _SCHED_KEYS:
        arrays[f"sched/{k}"] = _host(getattr(sched, k))
    if art._quantized is not None:
        qs = art._quantized
        meta["quantized"] = {"cells": int(qs.cells)}
        for k in _QUANT_KEYS:
            arrays[f"quant/{k}"] = _host(getattr(qs, k))
    if idx._policy is not None or idx._updates is not None:
        from repro_torch.update import MergePolicy

        policy = (idx._updates.policy if idx._updates is not None
                  else (idx._policy or MergePolicy()))
        meta["policy"] = dataclasses.asdict(policy)
    if idx._updates is not None:
        log = idx._updates
        meta["log"] = log.state_scalars()
        for k, v in log.state_arrays().items():
            arrays[f"log/{k}"] = v
    return meta, arrays


def _fsync_file(path) -> None:
    with open(path, "rb") as f:
        os.fsync(f.fileno())


def _fsync_dir(path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_state(dirpath, meta: dict, arrays: dict) -> None:
    """Write snapshot content into an (existing) directory and fsync it."""
    dirpath = pathlib.Path(dirpath)
    np.savez(dirpath / "arrays.npz", **arrays)
    _fsync_file(dirpath / "arrays.npz")
    with open(dirpath / "meta.json", "w") as f:
        json.dump(meta, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(dirpath)


def save_index(idx, path, *, extra_meta: Optional[dict] = None) -> None:
    """Atomically snapshot ``idx`` at ``path`` (a directory).

    Writes beside the target and publishes with ``os.replace``; an
    existing snapshot at ``path`` is superseded only after the new one is
    fully on disk.  ``extra_meta`` entries ride along in meta.json (the
    DurableIndex stores its op counter and generation there).
    """
    path = pathlib.Path(path)
    with _obs_trace.span("checkpoint.save", path=str(path)):
        path.parent.mkdir(parents=True, exist_ok=True)
        meta, arrays = index_state(idx)
        if extra_meta:
            meta.update(extra_meta)
        tmp = path.parent / f"{path.name}.tmp-{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        write_state(tmp, meta, arrays)
        if path.exists():
            shutil.rmtree(path)
        os.replace(tmp, path)
        _fsync_dir(path.parent)


def _read_meta(path: pathlib.Path) -> dict:
    """meta.json of the snapshot at ``path``; validates that both files
    are there and the version (without reading the arrays)."""
    meta_p, npz_p = path / "meta.json", path / "arrays.npz"
    if not meta_p.exists() or not npz_p.exists():
        raise SnapshotError(f"{path}: not a spatial-index snapshot")
    with open(meta_p) as f:
        meta = json.load(f)
    version = meta.get("format_version")
    if version != FORMAT_VERSION:
        raise SnapshotError(
            f"{path}: snapshot format {version!r} not supported "
            f"(this build reads version {FORMAT_VERSION})"
        )
    return meta


def read_state(path) -> Tuple[dict, dict]:
    """Read ``(meta, arrays)`` back; validates presence and version."""
    path = pathlib.Path(path)
    meta = _read_meta(path)
    with np.load(path / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return meta, arrays


def restore_index(meta: dict, arrays: dict, *, backend: str, device=None,
                  policy_override=None, **backend_opts):
    """Rehydrate a :class:`SpatialIndex` from snapshot content on
    ``device`` (the card when None)."""
    from repro_torch.convert import schedule_from_numpy
    from repro_torch.core.flat import QuantizedSchedule
    from repro_torch.index.api import BuildArtifacts, SpatialIndex
    from repro_torch.index.registry import get_backend
    from repro_torch.kernels.ops import resolve_device
    from repro_torch.update import MergePolicy, UpdateLog

    dev = resolve_device(device)
    s = meta["schedule"]
    fields = {k: arrays[f"sched/{k}"] for k in _SCHED_KEYS}
    fields.update(n_objects=int(s["n_objects"]),
                  root_unconditional=bool(s["root_unconditional"]),
                  test_object_mbr=bool(s["test_object_mbr"]))
    sched = schedule_from_numpy(fields, dev)
    quantized = None
    if meta.get("has_quantized"):
        quantized = QuantizedSchedule(
            sched,
            *(torch.from_numpy(np.ascontiguousarray(arrays[f"quant/{k}"])).to(dev)
              for k in _QUANT_KEYS),
            cells=int(meta["quantized"]["cells"]),
        )
    artifacts = BuildArtifacts.restore(meta["structure"], arrays["mbrs"],
                                       meta.get("build_opts"), sched, quantized)
    idx = SpatialIndex(artifacts, get_backend(backend), **backend_opts)
    idx._admission = meta.get("admission", "merge")
    policy = policy_override
    if policy is None and "policy" in meta:
        policy = MergePolicy(**meta["policy"])
    if policy is not None:
        idx._policy = policy
    if meta.get("has_updates"):
        structure = artifacts.structure
        build_opts = dict(artifacts.build_opts)
        log = UpdateLog.restore(
            artifacts,
            policy if policy is not None else MergePolicy(),
            rebuild=lambda mbrs: BuildArtifacts(structure, mbrs, device=dev, **build_opts),
            arrays={k[len("log/"):]: v for k, v in arrays.items() if k.startswith("log/")},
            scalars=meta["log"],
        )
        idx._updates = log
        idx._backend_base_epoch = log.base_epoch
    return idx


def load_index(path, *, backend: str = "cuda", device=None, **backend_opts):
    """Load a snapshot written by :func:`save_index` (or by the JAX
    package) onto ``backend`` on ``device``."""
    with _obs_trace.span("checkpoint.load", path=str(path), backend=backend):
        meta, arrays = read_state(path)
        return restore_index(meta, arrays, backend=backend, device=device, **backend_opts)


def snapshot_meta(path) -> Optional[dict]:
    """The snapshot's meta.json, or None if ``path`` holds no snapshot.
    Unlike the reference, which loads the arrays too, only meta.json is
    read: a publish is atomic, so a published meta.json has its arrays."""
    try:
        return _read_meta(pathlib.Path(path))
    except (SnapshotError, json.JSONDecodeError):
        return None
