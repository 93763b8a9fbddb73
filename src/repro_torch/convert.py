"""Carry a schedule, an mqr-KV index or a model's parameters built by the
JAX package across to the port.

The spatial system's "weights" are the built index.  These functions take the fields of the JAX package's ``LevelSchedule`` /
``QuantizedSchedule`` as numpy arrays (``dataclasses.asdict`` on the JAX
side gives them) and return the port's dataclasses on ``device``, so a
schedule the JAX package built through any path — an mqr tree schedule
included — can be swept by the port.  :func:`kvindex_from_numpy` and
:func:`inc_kvindex_from_numpy` do the same for the reference's ``KVIndex``
and ``IncKVIndex``, group pyramid included, so block selection can be held
to the reference on identical state.  :func:`params_from_numpy` turns a
transformer's parameter pytree (numpy leaves) into the port's parameters,
and :func:`opt_state_from_numpy` the reference's AdamW state into the
port's.
This module imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bulk import GroupPyramid
from repro_torch.core.flat import CELLS8, LevelSchedule, QuantizedSchedule
from repro_torch.core.kvindex import IncKVIndex, KVIndex
from repro_torch.kernels.ops import resolve_device


def _tensor(value, dtype, device) -> torch.Tensor:
    # a writable copy: a JAX array's buffer must not become the tensor's
    return torch.from_numpy(np.array(value, dtype=dtype, order="C", copy=True)).to(device)


def schedule_from_numpy(fields: dict, device=None) -> LevelSchedule:
    """The port's :class:`LevelSchedule` from a JAX ``LevelSchedule``'s
    fields (numpy arrays, ints and bools)."""
    dev = resolve_device(device)
    return LevelSchedule(
        mbr_cm=_tensor(fields["mbr_cm"], np.float32, dev),
        parent=_tensor(fields["parent"], np.int32, dev),
        n_real=_tensor(fields["n_real"], np.int32, dev),
        obj_mbr=_tensor(np.reshape(fields["obj_mbr"], (-1, 4)), np.float32, dev),
        obj_level=_tensor(fields["obj_level"], np.int32, dev),
        obj_slot=_tensor(fields["obj_slot"], np.int32, dev),
        obj_id=_tensor(fields["obj_id"], np.int32, dev),
        n_objects=int(fields["n_objects"]),
        root_unconditional=bool(fields["root_unconditional"]),
        test_object_mbr=bool(fields["test_object_mbr"]),
    )


def quantized_from_numpy(fields: dict, device=None) -> QuantizedSchedule:
    """The port's :class:`QuantizedSchedule` from a JAX
    ``QuantizedSchedule``'s fields; ``fields["base"]`` holds the base
    schedule's fields.  The hierarchical (``compact8``) fields ``mbr_q8``,
    ``split``, ``cells8`` and ``inv_cell8`` come across when present."""
    dev = resolve_device(device)
    parent_q = np.asarray(fields["parent_q"])
    if parent_q.dtype not in (np.uint16, np.int32):
        raise TypeError(f"parent_q must be uint16 or int32, got {parent_q.dtype}")
    return QuantizedSchedule(
        base=schedule_from_numpy(fields["base"], dev),
        mbr_q=_tensor(fields["mbr_q"], np.uint16, dev),
        parent_q=_tensor(parent_q, parent_q.dtype, dev),
        origin=_tensor(fields["origin"], np.float32, dev),
        inv_cell=_tensor(fields["inv_cell"], np.float32, dev),
        confirm_mbr=_tensor(np.reshape(fields["confirm_mbr"], (-1, 4)), np.float32, dev),
        cells=int(fields["cells"]),
        mbr_q8=(None if fields.get("mbr_q8") is None
                else _tensor(fields["mbr_q8"], np.uint8, dev)),
        split=int(fields.get("split", 0)),
        cells8=int(fields.get("cells8", CELLS8)),
        inv_cell8=(None if fields.get("inv_cell8") is None
                   else _tensor(fields["inv_cell8"], np.float32, dev)),
    )


def _fields(value) -> dict:
    """A NamedTuple's fields (``_asdict``) or a mapping, as a dict."""
    return value._asdict() if hasattr(value, "_asdict") else dict(value)


def kvindex_from_numpy(fields, device=None) -> KVIndex:
    """The port's :class:`KVIndex` from a reference ``KVIndex`` (the
    NamedTuple itself or its fields as a dict of numpy arrays; ``pyramid``
    likewise a ``GroupPyramid`` or a dict)."""
    dev = resolve_device(device)
    f = _fields(fields)
    p = _fields(f["pyramid"])
    pyramid = GroupPyramid(
        group_of=_tensor(p["group_of"], np.int32, dev),
        group_mbr=_tensor(p["group_mbr"], np.float32, dev),
        levels=int(p["levels"]),
    )
    return KVIndex(block_mbr=_tensor(f["block_mbr"], np.float32, dev), pyramid=pyramid)


def inc_kvindex_from_numpy(fields, device=None) -> IncKVIndex:
    """The port's :class:`IncKVIndex` from a reference ``IncKVIndex`` (the
    NamedTuple itself or a dict of its numpy fields)."""
    dev = resolve_device(device)
    f = _fields(fields)
    return IncKVIndex(
        block_mbr=_tensor(f["block_mbr"], np.float32, dev),
        group_mbr=_tensor(f["group_mbr"], np.float32, dev),
        group_of=_tensor(f["group_of"], np.int32, dev),
    )


def _leaf(value, shape, dtype: torch.dtype, device, path: str) -> torch.Tensor:
    """One parameter: a numpy array (a JAX bfloat16 array arrives as numpy's
    ``bfloat16`` extension type) held to the port's shape and dtype."""
    a = np.asarray(value)
    name = str(dtype).removeprefix("torch.")
    if a.dtype.name != name:
        raise TypeError(f"{path}: dtype {a.dtype.name}, the port's model wants {name}")
    if a.shape != tuple(shape):
        raise ValueError(f"{path}: shape {a.shape}, the port's model wants {tuple(shape)}")
    if dtype == torch.bfloat16:  # no numpy bfloat16 in torch: carry the bits
        bits = np.array(a.view(np.int16), order="C", copy=True)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return _tensor(a, a.dtype, device)


def _tree(value, want, device, path: str):
    if isinstance(want, dict):
        if not isinstance(value, dict) or set(value) != set(want):
            got = sorted(value) if isinstance(value, dict) else type(value).__name__
            raise ValueError(f"{path}: keys {got}, the port's model wants {sorted(want)}")
        return {k: _tree(value[k], want[k], device, f"{path}/{k}") for k in want}
    return _leaf(value, *want, device, path)


def _index(tree, i: int):
    """Superblock i of a stacked pytree (every leaf's leading axis)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


# Parameter trees the reference stacks on a leading axis (superblocks, MTP
# depths) and the port keeps as lists.
STACKED = ("blocks", "blocks_dense", "mtp")


def params_from_numpy(tree: dict, cfg, device=None) -> dict:
    """The port's parameters for ``cfg`` from the JAX package's parameter
    pytree with numpy leaves (``jax.tree.map(np.asarray, params)``).  The
    reference stacks the superblocks of ``params["blocks"]`` and
    ``params["blocks_dense"]``, and the depths of ``params["mtp"]``, on a
    leading axis; the port keeps them as lists, so that axis is unstacked.
    Every leaf keeps its dtype; a missing or extra key, a shape or a dtype
    other than the port's ``init_params`` would make raises."""
    from repro_torch.models.transformer import param_shapes

    return _unstack(tree, param_shapes(cfg), resolve_device(device), "params")


def _unstack(tree, want: dict, dev, name: str) -> dict:
    """A parameter-shaped pytree (numpy leaves, stacked as the reference's)
    as the port's tree of ``want``'s (shape, dtype) leaves."""
    if not isinstance(tree, dict) or set(tree) != set(want):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"{name}: keys {got}, the port's model wants {sorted(want)}")
    out = {}
    for key, spec in want.items():
        if key in STACKED:
            stacked = tree[key]
            n = len(spec)
            leaves = [np.asarray(v) for v in _flat(stacked)]
            if any(a.ndim == 0 or a.shape[0] != n for a in leaves):
                what = "depths" if key == "mtp" else "superblocks"
                raise ValueError(f"{name}/{key}: every leaf must stack {n} {what}")
            out[key] = [_tree(_index(stacked, i), spec[i], dev, f"{name}/{key}[{i}]")
                        for i in range(n)]
        else:
            out[key] = _tree(tree[key], spec, dev, f"{name}/{key}")
    return out


def _retyped(want, dtype):
    """``want``'s (shape, dtype) leaves with every dtype set to ``dtype``."""
    if isinstance(want, dict):
        return {k: _retyped(v, dtype) for k, v in want.items()}
    if isinstance(want, list):
        return [_retyped(v, dtype) for v in want]
    return want[0], dtype


def opt_state_from_numpy(state, cfg, device=None):
    """The port's ``optim.AdamWState`` from the reference's ``AdamWState``
    (``step``, ``m``, ``v``) with numpy leaves (``jax.tree.map(np.asarray,
    state)``): ``m`` and ``v`` unstacked as :func:`params_from_numpy`
    unstacks the parameters, in the moments' own dtype (float32 or
    bfloat16, the reference's ``moments_dtype``); ``step`` a 0-d int32."""
    from repro_torch.models.modules import DTYPES
    from repro_torch.models.transformer import param_shapes
    from repro_torch.optim.adamw import AdamWState

    dev = resolve_device(device)
    step, m, v = state
    names = {np.asarray(a).dtype.name for a in _flat(m) + _flat(v)}
    if len(names) != 1 or next(iter(names)) not in DTYPES:
        raise TypeError(f"opt state moments: dtypes {sorted(names)}, want one of {sorted(DTYPES)}")
    want = _retyped(param_shapes(cfg), DTYPES[names.pop()])
    return AdamWState(step=torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=dev),
                      m=_unstack(m, want, dev, "opt/m"), v=_unstack(v, want, dev, "opt/v"))


def _flat(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _flat(v)]
    return [tree]
