"""Logical-axis sharding rules: parameter/optimizer/batch/cache specs.

Counterpart of ``repro.sharding.rules``, with the same name-based rules in
the same order.  Mesh axes: ``("pod", "data", "model")`` multi-pod or
``("data", "model")`` single-pod.  Logical mapping (DESIGN.md §4.1):

  batch/fsdp -> ("pod", "data")   ZeRO-3: params+optimizer sharded over the
                                  data axes
  tp         -> "model"           heads / d_ff / vocab / experts
  kv_seq     -> "model" or data   long-context decode (flash-decoding combine)

Rules are name-based on the parameter path; unmatched leaves replicate.

A spec is a :class:`PartitionSpec`: a tuple with, per tensor dim, ``None``,
one mesh axis name, or a tuple of axis names (major first).  A mesh is
anything with axis names and sizes: a ``torch.distributed`` ``DeviceMesh``
(``mesh_dim_names``), a ``launch.mesh.MeshShape`` (``axis_names`` and a
``shape`` mapping, as a JAX mesh) or an ``ft.elastic.MeshPlan``.  Three
things differ from the reference, on purpose (ROADMAP C34):

- No stacked lead.  The reference stacks the superblocks of ``blocks`` and
  the depths of ``mtp`` on a leading axis for ``jax.lax.scan`` and gives it
  ``None``; the port's ``params["blocks"]`` and ``params["mtp"]`` are lists
  of one dict a superblock (C25), so its specs have no such entry.  Caches
  likewise (``caches["all"]`` is a list).
- The kv layout.  Attention caches are (B, Hkv, S, Dh) here, (B, S, Hkv,
  Dh) there (C24), so the ``k``/``v`` rule names the port's dims: kv heads
  over ``model``, else the sequence over ``model``.  The MLA latent keeps
  the reference's layout (C28).
- Placements.  :func:`param_shardings`, :func:`cache_shardings` and
  :func:`batch_shardings` give DTensor placements (one ``Shard`` or
  ``Replicate`` a mesh dim) where the reference gives ``NamedSharding``s;
  a dim sharded over ``("pod", "data")`` is ``Shard(i)`` on both mesh
  dims, pod-major, as JAX orders them.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Callable, Tuple

from torch.distributed.tensor import Replicate, Shard


class PartitionSpec(tuple):
    """Per tensor dim: ``None``, one mesh axis name, or a tuple of axis
    names; ``PartitionSpec("data", None)`` as JAX writes it."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``, a ``MeshShape`` or an
    ``ft.elastic.MeshPlan``, in mesh order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    if isinstance(mesh.shape, Mapping):
        return {n: mesh.shape[n] for n in mesh.axis_names}
    return dict(zip(mesh.axis_names, mesh.shape))


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh_axes(mesh) if a in ("pod", "data"))


def axis_size(mesh, names) -> int:
    if isinstance(names, str):
        names = (names,)
    sizes = mesh_axes(mesh)
    out = 1
    for n in names:
        out *= sizes[n]
    return out


def _div(dim: int, n: int) -> bool:
    return n > 0 and dim % n == 0


def spec_for_param(path: str, shape, mesh) -> PartitionSpec:
    """Return the PartitionSpec for a parameter identified by its tree path
    (``blocks/3/l0/mixer/wq``; no stacked lead, see the module's notes)."""
    fsdp = data_axes(mesh)
    tp = "model"
    ntp = axis_size(mesh, tp)
    nfsdp = axis_size(mesh, fsdp)
    rank = len(shape)

    def ok(i, n):
        return _div(shape[i], n)

    name = path.split("/")[-1]
    final = PartitionSpec

    # --- embeddings / heads -------------------------------------------------
    if name == "embed":
        if rank == 3:  # audio codebooks (K, V, D)
            return final(None, tp if ok(1, ntp) else None, fsdp if ok(2, nfsdp) else None)
        return final(tp if ok(0, ntp) else None, fsdp if ok(1, nfsdp) else None)
    if name == "lm_head":
        if rank == 3:  # (K, D, V)
            return final(None, fsdp if ok(1, nfsdp) else None, tp if ok(2, ntp) else None)
        return final(fsdp if ok(0, nfsdp) else None, tp if ok(1, ntp) else None)

    # --- attention -----------------------------------------------------------
    if name in ("wq", "wk", "wv"):  # (D, H, Dh)
        return final(fsdp if ok(0, nfsdp) else None, tp if ok(1, ntp) else None, None)
    if name == "wo":  # (H*Dh, D)
        return final(tp if ok(0, ntp) else None, fsdp if ok(1, nfsdp) else None)
    # --- MLA ------------------------------------------------------------------
    if name in ("wq_a", "wkv_a"):  # (D, R)
        return final(fsdp if ok(0, nfsdp) else None, None)
    if name in ("wq_b", "wk_b", "wv_b"):  # (R, H, k)
        return final(fsdp if ok(0, nfsdp) else None, tp if ok(1, ntp) else None, None)
    # --- MoE -------------------------------------------------------------------
    if name == "router":
        return final(fsdp if ok(0, nfsdp) else None, None)
    if name in ("w_in", "w_gate") and rank == 3:  # (E, D, F) experts
        return final(tp if ok(0, ntp) else None, fsdp if ok(1, nfsdp) else None, None)
    if name == "w_out" and rank == 3:  # (E, F, D)
        return final(tp if ok(0, ntp) else None, None, fsdp if ok(1, nfsdp) else None)
    # --- dense FFN --------------------------------------------------------------
    if name in ("w_in", "w_gate") and rank == 2:  # (D, F)
        return final(fsdp if ok(0, nfsdp) else None, tp if ok(1, ntp) else None)
    if name == "w_out" and rank == 2:  # (F, D)
        return final(tp if ok(0, ntp) else None, fsdp if ok(1, nfsdp) else None)
    # --- mamba2 -------------------------------------------------------------------
    if name == "in_proj":  # (D, X)
        return final(fsdp if ok(0, nfsdp) else None, tp if ok(1, ntp) else None)
    if name == "out_proj":  # (d_inner, D)
        return final(tp if ok(0, ntp) else None, fsdp if ok(1, nfsdp) else None)
    if name == "conv_w":  # (K, C)
        return final(None, tp if ok(1, ntp) else None)
    if name == "conv_b":
        return final(tp if ok(0, ntp) else None)
    # --- rglru -----------------------------------------------------------------------
    if name in ("in_x", "in_gate"):  # (D, W)
        return final(fsdp if ok(0, nfsdp) else None, tp if ok(1, ntp) else None)
    if name in ("w_a", "w_i"):  # (W, W)
        return final(None, tp if ok(1, ntp) else None)
    if name == "out":  # (W, D)
        return final(tp if ok(0, ntp) else None, fsdp if ok(1, nfsdp) else None)
    if name == "proj":  # MTP (2D, D)
        return final(fsdp if ok(0, nfsdp) else None, None)
    # norms / scalars / probes / biases: replicate
    return final(*((None,) * rank))


def map_with_path(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """``fn(path, leaf)`` over a nested dict / list, keeping the nesting;
    paths join keys and list indices with ``/``.  Tuples are leaves (specs,
    placements and the pairs of ``ft.elastic.reshard_plan`` are tuples)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def leaves_with_path(tree) -> list:
    """[(path, leaf)] of a nested dict / list, in :func:`map_with_path`'s
    order."""
    out = []
    map_with_path(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def param_specs(params, mesh):
    """Tree of PartitionSpec matching ``params``."""
    return map_with_path(lambda path, leaf: spec_for_param(path, leaf.shape, mesh), params)


def batch_spec(shape, mesh) -> PartitionSpec:
    """Token batches: batch dim over the data axes when divisible."""
    fsdp = data_axes(mesh)
    n = axis_size(mesh, fsdp)
    lead = fsdp if _div(shape[0], n) else None
    return PartitionSpec(lead, *([None] * (len(shape) - 1)))


def cache_spec(path: str, shape, mesh) -> PartitionSpec:
    """KV/state cache sharding for serving.

    Preference order per tensor: batch over data axes; kv-heads over model;
    otherwise sequence over model (flash-decoding style partial softmax).
    """
    fsdp = data_axes(mesh)
    tp = "model"
    ntp = axis_size(mesh, tp)
    nfsdp = axis_size(mesh, fsdp)
    name = path.split("/")[-1]
    if name == "pos" or name.startswith("idx_"):
        return PartitionSpec(*([None] * len(shape)))
    b_ax = fsdp if _div(shape[0], nfsdp) else None

    if name in ("k", "v"):  # (B, Hkv, S, Dh): the port's layout (C24)
        if _div(shape[1], ntp):
            return PartitionSpec(b_ax, tp, None, None)
        if _div(shape[2], ntp):
            return PartitionSpec(b_ax, None, tp, None)
        return PartitionSpec(b_ax, None, None, None)
    if name == "c_kv" or name == "k_rope":  # (B, S, R)
        if _div(shape[1], ntp):
            return PartitionSpec(b_ax, tp, None)
        return PartitionSpec(b_ax, None, None)
    if name == "ssm":  # (B, H, N, P)
        return PartitionSpec(b_ax, tp if _div(shape[1], ntp) else None, None, None)
    if name == "conv":  # (B, K-1, C)
        return PartitionSpec(b_ax, None, tp if _div(shape[2], ntp) else None)
    if name == "h":  # (B, W)
        return PartitionSpec(b_ax, tp if _div(shape[1], ntp) else None)
    return PartitionSpec(*([None] * len(shape)))


def placements(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(i)`` where tensor dim i names that axis, else ``Replicate()``.
    Mesh dims in mesh order, so ``("pod", "data")`` is pod-major."""
    out = []
    for axis in mesh_axes(mesh):
        dims = [i for i, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def shard_shape(spec: PartitionSpec, shape, mesh) -> tuple:
    """The per-device shape of a tensor of ``shape`` under ``spec``."""
    out = []
    for dim, e in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        n = 1 if e is None else axis_size(mesh, e)
        if dim % n:
            raise ValueError(f"dim {dim} does not divide over {e} ({n})")
        out.append(dim // n)
    return tuple(out)


def param_shardings(params, mesh):
    """Tree of placements matching ``params``."""
    return map_with_path(
        lambda path, leaf: placements(spec_for_param(path, leaf.shape, mesh), mesh), params)


def cache_shardings(caches, mesh):
    """Tree of placements matching ``caches``."""
    return map_with_path(
        lambda path, leaf: placements(cache_spec(path, leaf.shape, mesh), mesh), caches)


def batch_shardings(batch, mesh):
    """Tree of placements matching ``batch``."""
    return map_with_path(lambda path, leaf: placements(batch_spec(leaf.shape, mesh), mesh),
                         batch)
