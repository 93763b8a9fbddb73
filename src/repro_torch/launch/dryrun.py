"""Dry run: every (arch x shape x mesh) cell's step on the ``meta`` device,
recording what it needs of one card.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each cell
with XLA on 512 forced host devices.  Here nothing is compiled and nothing
allocated: the step of ``launch/steps.py`` runs once on ``meta`` tensors
(``steps.abstract_params``, ``steps.abstract_opt_state``,
``registry.input_specs``) under ``launch.op_cost.OpCost``, which counts its
FLOPs and bytes and tracks its live storages.  The record keeps the
reference's keys (``arch``, ``shape``, ``mesh``, ``n_devices``, ``kind``,
``params``, ``active_params``, ``model_flops``, ``memory``, ``cost``,
``collectives``, ``moments_dtype``).

Meshes:

- ``card``: one H100 (1x1).  ``cost`` and ``memory`` come from the run on
  ``meta``; ``collectives`` are zero, and the record says so.
- ``single`` (16x16) and ``multi`` (2x16x16): the step runs sharded, as
  the reference's ``jax.jit(..., in_shardings=...)``: a real
  ``DeviceMesh`` of 256 or 512 ranks on a fake process group
  (``launch.mesh.fake_production_mesh``, seen from rank 0), the arguments
  placed by ``launch.steps.place`` with the rules' placements as ``meta``
  local shards, and ``OpCost`` counting what one device runs: per-device
  FLOPs and bytes (``cost``), the peak of its live storages
  (``memory.peak_bytes_per_device``) and the collectives DTensor issues
  with their operand and ring-model wire bytes (``collectives``).
  ``memory`` also keeps the rules' per-device argument bytes by kind
  (``sharding.shard_shape``), which the placed shards equal.  These are
  counts on the CPU, not times.  Every arch's train, prefill and dense
  decode steps run sharded; the mqr-KV sparse decode, which does not run
  sharded yet, keeps only those argument bytes, ``cost`` and
  ``collectives`` ``null``, and a note naming ROADMAP A4d.

Usage (no card needed)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh card
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama32_1b \\
        --mesh single,multi
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama32_1b \\
        --shape train_4k --mesh single --batch 32 --seq 2048

Records go to ``build/dryrun/`` (``--out``); it exits 1 listing the cells
that failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import registry
from repro_torch.launch import steps
from repro_torch.launch.mesh import fake_production_mesh, make_card_mesh, make_production_mesh
from repro_torch.launch.op_cost import OpCost, empty_collectives, storage_bytes
from repro_torch.models import transformer as T
from repro_torch.models.modules import tree_leaves
from repro_torch.optim import adamw
from repro_torch.sharding import rules

MESHES = ("card", "single", "multi")
SHARDED_NOTE = ("per-device argument bytes from the sharding rules only: the mqr-KV "
                "sparse decode does not run sharded on a DeviceMesh yet (ROADMAP A4d)")


def _apply_overrides(cfg, overrides):
    if not overrides:
        return cfg
    kw = {}
    for ov in overrides:
        k, v = ov.split("=", 1)
        field = {f.name: f for f in dataclasses.fields(cfg)}[k]
        if field.type in ("int", int):
            v = int(v)
        elif field.type in ("float", float):
            v = float(v)
        elif field.type in ("bool", bool):
            v = v.lower() in ("1", "true")
        kw[k] = v
    return dataclasses.replace(cfg, **kw)


def make_mesh(mesh_name: str):
    if mesh_name == "card":
        return make_card_mesh()
    if mesh_name not in MESHES:
        raise ValueError(f"mesh must be one of {MESHES}, got {mesh_name!r}")
    return make_production_mesh(multi_pod=mesh_name == "multi")


def opt_config(cfg) -> adamw.AdamWConfig:
    """bf16 moments for >100B models: the recorded memory-fit choice."""
    return adamw.AdamWConfig(
        moments_dtype="bfloat16" if cfg.param_count() > 100e9 else "float32")


def mqr_sparse(cfg, shape: str, tag: str = "") -> bool:
    """The mqr-KV sparse path for ``long_500k`` on configs with kv attention;
    a ``dense`` tag turns it off (the full-attention baseline), a ``sparse``
    tag on at any decode shape."""
    has_kv_attn = any(k in ("attn", "mla") for k in cfg.block_pattern + cfg.tail_pattern)
    if "dense" in tag:
        return False
    return has_kv_attn and (shape == "long_500k" or "sparse" in tag)


def model_flops(cfg, kind: str, global_batch: int, seq: int) -> int:
    """The reference's model FLOPs: 6·N_active·tokens (train), 2·N_active·tokens
    (prefill), 2·N_active·batch (one decode step; the KV read is memory)."""
    n = cfg.active_param_count()
    if kind == "train":
        return 6 * n * global_batch * seq
    if kind == "prefill":
        return 2 * n * global_batch * seq
    return 2 * n * global_batch


def step_fn(cfg, shape: str, tag: str = ""):
    """The cell's step function (``launch/steps.py``): train ``(params,
    opt_state, batch)``, prefill ``(params, batch)``, decode ``(params,
    tokens, caches, pos)``."""
    kind = registry.SHAPES[shape]["kind"]
    if kind == "train":
        return steps.make_train_step(cfg, opt_config(cfg))
    if kind == "prefill":
        return steps.make_prefill_step(cfg)
    return steps.make_serve_step(cfg, mqr_sparse=mqr_sparse(cfg, shape, tag))


def cell_args(cfg, shape: str, global_batch=None, seq_len=None) -> tuple:
    """The step's arguments on ``meta``, in :func:`step_fn`'s order."""
    kind = registry.SHAPES[shape]["kind"]
    params = steps.abstract_params(cfg)
    specs = registry.input_specs(cfg, shape, global_batch, seq_len)
    if kind == "train":
        return params, steps.abstract_opt_state(params, opt_config(cfg)), specs["batch"]
    if kind == "prefill":
        return params, specs["batch"]
    return params, specs["tokens"], specs["caches"], specs["pos"]


def run_step(fn, args, kind: str):
    """Run one step under :class:`OpCost` (live: its arguments) -> (cost,
    outputs).  Prefill and decode run under ``torch.inference_mode()``."""
    with OpCost(live=args) as cost:
        if kind == "train":
            out = fn(*args)
        else:
            with torch.inference_mode():
                out = fn(*args)
    return cost, out


def place_args(args, kind: str, mesh) -> tuple:
    """:func:`cell_args` placed on ``mesh`` as the reference's dry run
    places them (``in_shardings``): parameters and moments by
    ``rules.param_shardings``, the batch and the decode tokens by
    ``batch_spec``, caches by ``rules.cache_shardings``; the AdamW step
    replicated and the decode position a plain 0-d tensor."""
    params = steps.place(args[0], rules.param_shardings(args[0], mesh), mesh)
    if kind == "train":
        batch = args[2]
        return (params, steps.place_opt_state(args[1], args[0], mesh),
                steps.place(batch, rules.batch_shardings(batch, mesh), mesh))
    if kind == "prefill":
        return params, steps.place(args[1], rules.batch_shardings(args[1], mesh), mesh)
    _, tokens, caches, pos = args
    tokens = steps.place({"t": tokens}, rules.batch_shardings({"t": tokens}, mesh), mesh)["t"]
    return params, tokens, steps.place(caches, rules.cache_shardings(caches, mesh), mesh), pos


def local_bytes(tree) -> int:
    """Bytes of the local shards (a plain tensor: itself) of ``tree``'s
    tensors."""
    return sum(_local(t).numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def storage_set(tree) -> dict:
    """{storage id: allocator bytes} of the tensors of ``tree`` (a DTensor's
    local shard)."""
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = _local(t).untyped_storage()
            out[id(st)] = storage_bytes(st.nbytes())
    return out


def card_memory(cost: OpCost, args, out) -> dict:
    """The reference's memory keys from one ``meta`` run: arguments (the
    live storages), outputs that are new storages, outputs aliasing an
    argument, temporaries (the peak less arguments and new outputs), and
    the peak split by what made each live storage."""
    arg = storage_set(args)
    outs = storage_set(out)
    new = sum(n for k, n in outs.items() if k not in arg)
    alias = sum(n for k, n in outs.items() if k in arg)
    return {
        "argument_bytes_per_device": cost.live_bytes,
        "output_bytes_per_device": new,
        "temp_bytes_per_device": cost.peak_bytes - cost.live_bytes - new,
        "alias_bytes_per_device": alias,
        "peak_bytes_per_device": cost.peak_bytes,
        "peak_by_op": cost.peak_by_op.most_common(8),
    }


def sharded_memory(cfg, shape: str, mesh, global_batch=None, seq_len=None) -> dict:
    """Per-device argument bytes on a production mesh from the rules'
    ``shard_shape``: parameters, moments (train), batch, caches (decode)."""
    kind = registry.SHAPES[shape]["kind"]
    params = steps.abstract_params(cfg)
    specs = registry.input_specs(cfg, shape, global_batch, seq_len)

    def per_device(tree, spec_of):
        return sum(math.prod(rules.shard_shape(spec_of(path, t), t.shape, mesh))
                   * t.element_size()
                   for path, t in rules.leaves_with_path(tree))

    def param_spec(path, t):
        return rules.spec_for_param(path, t.shape, mesh)

    out = {"params_bytes_per_device": per_device(params, param_spec)}
    if kind == "train":
        dt = adamw.DTYPES[opt_config(cfg).moments_dtype]
        moments = rules.map_with_path(lambda _, t: torch.empty(t.shape, dtype=dt, device="meta"),
                                      params)
        out["moments_bytes_per_device"] = 2 * per_device(moments, param_spec)
    if kind in ("train", "prefill"):
        out["batch_bytes_per_device"] = per_device(
            specs["batch"], lambda _, t: rules.batch_spec(t.shape, mesh))
    else:
        out["batch_bytes_per_device"] = per_device(
            {"tokens": specs["tokens"]}, lambda _, t: rules.batch_spec(t.shape, mesh))
        out["cache_bytes_per_device"] = per_device(
            specs["caches"], lambda path, t: rules.cache_spec(path, t.shape, mesh))
    out["argument_bytes_per_device"] = sum(out.values())
    out["peak_bytes_per_device"] = None
    return out


def runs_sharded(cfg, shape: str, tag: str = "") -> bool:
    """Whether the cell's step runs sharded on a ``DeviceMesh`` yet:
    everything of ``transformer.runs_sharded`` (every mixer, FFN and
    frontend of the ten configs) but the mqr-KV sparse decode."""
    kind = registry.SHAPES[shape]["kind"]
    return T.runs_sharded(cfg) and not (kind == "decode" and mqr_sparse(cfg, shape, tag))


def cost_record(cost: OpCost) -> dict:
    return {"flops_per_device": cost.flops, "bytes_accessed_per_device": cost.bytes,
            "kernels": cost.kernels, "by_op": cost.by_op()}


def run_cell(arch: str, shape: str, mesh_name: str, out_dir: pathlib.Path,
             overrides=None, tag: str = "", force: bool = False, *, global_batch=None,
             seq_len=None):
    """One cell's record, written to ``out_dir/<arch>__<shape>__<mesh>[__tag].json``
    (an existing record is read back unless ``force``).  ``global_batch``
    and ``seq_len`` cut the shape."""
    suffix = f"__{tag}" if tag else ""
    out_path = pathlib.Path(out_dir) / f"{arch}__{shape}__{mesh_name}{suffix}.json"
    if out_path.exists() and not force:
        print(f"[skip] {out_path.name}")
        return json.loads(out_path.read_text())

    cfg = _apply_overrides(registry.get_config(arch), overrides)
    mesh = make_mesh(mesh_name)
    kind = registry.SHAPES[shape]["kind"]
    seq = seq_len or registry.SHAPES[shape]["seq_len"]
    gbatch = global_batch or registry.SHAPES[shape]["global_batch"]
    record = {
        "arch": arch, "shape": shape, "mesh": mesh_name, "tag": tag,
        "n_devices": mesh.n_devices, "kind": kind, "seq_len": seq, "global_batch": gbatch,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "overrides": list(overrides or []),
        "model_flops": model_flops(cfg, kind, gbatch, seq),
    }
    if kind == "train":
        record["moments_dtype"] = opt_config(cfg).moments_dtype
    if kind == "decode":
        record["mqr_sparse"] = mqr_sparse(cfg, shape, tag)
    t0 = time.time()
    if mesh_name == "card":
        args = cell_args(cfg, shape, gbatch, seq)
        cost, out = run_step(step_fn(cfg, shape, tag), args, kind)
        record["memory"] = card_memory(cost, args, out)
        record["cost"] = cost_record(cost)
        record["collectives"] = dict(empty_collectives(), note="one card: no collectives")
    elif runs_sharded(cfg, shape, tag):
        with fake_production_mesh(multi_pod=mesh_name == "multi") as dmesh:
            args = place_args(cell_args(cfg, shape, gbatch, seq), kind, dmesh)
            cost, out = run_step(step_fn(cfg, shape, tag), args, kind)
            memory = card_memory(cost, args, out)
            memory["argument_bytes_per_device"] = local_bytes(args)
            record["memory"] = dict(sharded_memory(cfg, shape, mesh, gbatch, seq), **memory)
            record["cost"] = cost_record(cost)
            record["collectives"] = cost.collectives
            del args, out
    else:
        record["memory"] = sharded_memory(cfg, shape, mesh, gbatch, seq)
        record["cost"] = None
        record["collectives"] = None
        record["note"] = SHARDED_NOTE
    record["run_s"] = round(time.time() - t0, 2)

    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(record, indent=1))
    mem = record["memory"]
    if record["cost"] is not None:
        print(f"[ok] {out_path.name}: peak={mem['peak_bytes_per_device'] / 2**30:.2f} GiB "
              f"flops={record['cost']['flops_per_device']:.3e} "
              f"bytes={record['cost']['bytes_accessed_per_device']:.3e} "
              f"coll_wire={record['collectives']['total_wire_bytes'] / 2**30:.3f} GiB "
              f"({record['run_s']}s)")
    else:
        print(f"[ok] {out_path.name}: arguments="
              f"{mem['argument_bytes_per_device'] / 2**30:.2f} GiB/dev ({record['run_s']}s)")
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="card",
                    help="card, single, multi, a comma list of them, or all")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--override", action="append", default=[],
                    help="ModelConfig field=value (perf iterations)")
    ap.add_argument("--batch", type=int, default=None, help="global batch (cuts the shape)")
    ap.add_argument("--seq", type=int, default=None, help="sequence length (cuts the shape)")
    ap.add_argument("--tag", default="", help="suffix for the output JSON")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = list(registry.ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(registry.SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = list(MESHES) if args.mesh == "all" else args.mesh.split(",")
    out_dir = pathlib.Path(args.out)

    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                try:
                    run_cell(arch, shape, mesh_name, out_dir, args.override, args.tag,
                             args.force, global_batch=args.batch, seq_len=args.seq)
                except Exception as e:  # noqa: BLE001 — record and continue
                    failures.append((arch, shape, mesh_name, repr(e)))
                    print(f"[FAIL] {arch} {shape} {mesh_name}: {e}")
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} failures:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nALL CELLS PASSED")


if __name__ == "__main__":
    main()
