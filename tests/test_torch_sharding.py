"""The port's sharding rules, meshes, elastic re-meshing, shard router and
input specs (``repro_torch.sharding``, ``launch.mesh``, ``ft.elastic``,
``data.spatial_router``, ``configs.paper_spatial``,
``configs.registry.input_specs``) held to the JAX package's on the CPU.

The reference's rule functions read only ``mesh.shape`` and
``mesh.axis_names``, so they are called with a duck mesh and no JAX
devices.  Its leaves under ``blocks``, ``blocks_dense`` and ``mtp`` (and
its caches outside ``tail``) carry a stacked layer axis whose spec entry is
``None``; the port's trees are lists with no such axis (ROADMAP C25, C34),
so each reference spec is compared with its first entry removed, and the
port's list indices are dropped from its paths.  Attention caches are
compared through the (B, Hkv, S, Dh) transpose (C24).  Everything is equal
exactly: no tolerance.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import paper_spatial as ref_paper
from repro.configs import registry as ref_registry
from repro.core import datasets as ref_datasets
from repro.data import spatial_router as ref_router
from repro.ft import elastic as ref_elastic
from repro.launch import steps as ref_steps
from repro.models import transformer as ref_T
from repro.sharding import rules as ref_rules
from repro_torch.configs import paper_spatial, registry
from repro_torch.core import datasets
from repro_torch.core import mbr as M
from repro_torch.data import route_shards
from repro_torch.ft import MeshPlan, build_mesh, plan_mesh, reshard_plan
from repro_torch.launch import steps
from repro_torch.launch.mesh import MeshShape, make_host_mesh, make_production_mesh
from repro_torch.sharding import rules

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"1x1": (("data", "model"), (1, 1)), "4x2": (("data", "model"), (4, 2)),
          "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
STACKED = ("blocks", "blocks_dense", "mtp")


def port_mesh(name):
    names, sizes = MESHES[name]
    return MeshShape(names, sizes)


def duck_mesh(name):
    names, sizes = MESHES[name]
    return types.SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes)))


def norm(spec) -> tuple:
    """Spec entries as JAX keeps them: a one-name tuple is the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def ref_leaves(tree) -> dict:
    """{path: leaf} of a reference pytree, paths as its rules spell them."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {ref_rules._path_str(path): leaf for path, leaf in flat}


def ref_path(port_path: str) -> str:
    """The reference's path of a port leaf: the list indices dropped."""
    return "/".join(p for p in port_path.split("/") if not p.isdigit())


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    return ref_leaves(ref_steps.abstract_params(ref_registry.get_config(arch)))


@functools.lru_cache(maxsize=None)
def ref_caches(arch, b, s):
    cfg = ref_registry.get_config(arch)
    return ref_leaves(jax.eval_shape(lambda: ref_T.init_caches(cfg, b, s)))


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", registry.ARCHS)
def test_param_specs_equal_the_reference(arch, mesh_name):
    ref = ref_params(arch)
    port = rules.leaves_with_path(steps.abstract_params(registry.get_config(arch)))
    specs = rules.param_specs(steps.abstract_params(registry.get_config(arch)),
                              port_mesh(mesh_name))
    seen = set()
    for (path, leaf), (_, spec) in zip(port, rules.leaves_with_path(specs)):
        rp = ref_path(path)
        seen.add(rp)
        stacked = rp.split("/")[0] in STACKED
        want = ref_rules.spec_for_param(rp, ref[rp].shape, duck_mesh(mesh_name))
        want = norm(want)[1:] if stacked else norm(want)
        assert norm(spec) == want, (path, spec, want)
        assert tuple(leaf.shape) == tuple(ref[rp].shape[1:] if stacked else ref[rp].shape)
    assert seen == set(ref)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", registry.ARCHS)
def test_cache_specs_equal_the_reference(arch, mesh_name):
    b, s = 128, 32_768
    ref = ref_caches(arch, b, s)
    caches = registry.input_specs(registry.get_config(arch), "decode_32k")["caches"]
    seen = set()
    for path, leaf in rules.leaves_with_path(caches):
        rp = ref_path(path)
        seen.add(rp)
        stacked = rp.split("/")[0] != "tail"
        rshape = ref[rp].shape[1:] if stacked else ref[rp].shape
        want = norm(ref_rules.cache_spec(rp, ref[rp].shape, duck_mesh(mesh_name)))
        want = want[1:] if stacked else want
        name = rp.split("/")[-1]
        if name in ("k", "v"):  # (B, S, Hkv, Dh) there, (B, Hkv, S, Dh) here (C24)
            rshape = (rshape[0], rshape[2], rshape[1], rshape[3])
            want = (want[0], want[2], want[1], want[3])
        assert tuple(leaf.shape) == tuple(rshape), path
        assert str(leaf.dtype).removeprefix("torch.") == str(ref[rp].dtype), path
        assert norm(rules.cache_spec(path, leaf.shape, port_mesh(mesh_name))) == want, path
    assert seen == set(ref)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_specs_equal_the_reference(mesh_name):
    for shape in ((256, 4096), (32, 32_768, 4), (1, 1), (7, 3), (512, 8, 2048)):
        want = norm(ref_rules.batch_spec(shape, duck_mesh(mesh_name)))
        assert norm(rules.batch_spec(shape, port_mesh(mesh_name))) == want


def test_placements_and_shard_shape():
    mesh = port_mesh("2x16x16")
    spec = rules.PartitionSpec(("pod", "data"), "model", None)
    from torch.distributed.tensor import Replicate, Shard

    assert rules.placements(spec, mesh) == (Shard(0), Shard(0), Shard(1))
    assert rules.placements(rules.PartitionSpec(None, None), mesh) == (Replicate(),) * 3
    assert rules.shard_shape(spec, (64, 32, 5), mesh) == (2, 2, 5)
    with pytest.raises(ValueError):
        rules.shard_shape(spec, (63, 32, 5), mesh)
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).n_devices == 512


FAKE_PG = """
import json, sys
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from repro_torch.configs import registry
from repro_torch.launch import steps
from repro_torch.ft import build_mesh, plan_mesh
from repro_torch.sharding import rules
world, names, sizes = int(sys.argv[1]), tuple(sys.argv[2].split(",")), tuple(
    int(x) for x in sys.argv[3].split(","))
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
mesh = init_device_mesh("cpu", sizes, mesh_dim_names=names)
bad, n = [], 0
for arch in registry.ARCHS:
    cfg = registry.get_config(arch)
    trees = {"params": (steps.abstract_params(cfg), rules.spec_for_param),
             "caches": (registry.input_specs(cfg, "decode_32k")["caches"], rules.cache_spec)}
    for kind, (tree, spec_fn) in trees.items():
        for path, leaf in rules.leaves_with_path(tree):
            spec = spec_fn(path, leaf.shape, mesh)
            pl = rules.placements(spec, mesh)
            local = distribute_tensor(leaf, mesh, pl).to_local().shape
            n += 1
            if tuple(local) != rules.shard_shape(spec, leaf.shape, mesh):
                bad.append((arch, path, tuple(local)))
plan = plan_mesh(world, model_parallel=sizes[-1])
built = build_mesh(plan, device_type="cpu")
print(json.dumps({"bad": bad, "n": n, "built": [list(built.mesh_dim_names), list(built.shape)],
                  "plan": [list(plan.axis_names), list(plan.shape)]}))
"""


@pytest.mark.parametrize("world,names,sizes", [
    (8, ("data", "model"), (4, 2)), (512, ("pod", "data", "model"), (2, 16, 16))])
def test_dtensor_local_shapes_equal_shard_shape(world, names, sizes):
    """A fake process group (tests only) of ``world`` ranks: DTensor's local
    shape of every parameter and decode cache of the ten archs equals
    ``shard_shape``, and ``build_mesh`` of ``plan_mesh(world)`` is the
    plan's mesh."""
    res = subprocess.run([sys.executable, "-c", FAKE_PG, str(world), ",".join(names),
                          ",".join(map(str, sizes))], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["bad"] == [] and out["n"] > 1000
    assert out["built"] == out["plan"] == [list(names), list(sizes)]


JAX_SHARD = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, dataclasses
import jax
from repro.configs import registry
from repro.launch import steps
from repro.sharding import rules
cfg = dataclasses.replace(registry.get_config("llama32_1b", smoke=True), remat=False)
mesh = jax.make_mesh((4, 2), ("data", "model"))
params = steps.abstract_params(cfg)
sh = rules.param_shardings(params, mesh)
flat, _ = jax.tree_util.tree_flatten_with_path(params)
shard = jax.tree_util.tree_leaves(sh)
print(json.dumps({rules._path_str(p): list(s.shard_shape(l.shape))
                  for (p, l), s in zip(flat, shard)}))
"""


def test_smoke_llama_shard_shapes_equal_jax_named_sharding():
    """The smoke llama's per-device shapes on a (4, 2) mesh equal JAX's
    ``NamedSharding.shard_shape`` on 8 forced host devices (stacked lead
    dropped: it is never sharded)."""
    res = subprocess.run([sys.executable, "-c", JAX_SHARD], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    cfg = dataclasses.replace(registry.get_config("llama32_1b", smoke=True), remat=False)
    mesh = port_mesh("4x2")
    seen = set()
    for path, leaf in rules.leaves_with_path(steps.abstract_params(cfg)):
        rp = ref_path(path)
        seen.add(rp)
        w = want[rp][1:] if rp.split("/")[0] in STACKED else want[rp]
        spec = rules.spec_for_param(path, leaf.shape, mesh)
        assert list(rules.shard_shape(spec, leaf.shape, mesh)) == w, path
    assert seen == set(want)


# ---------------------------------------------------------------------------
# meshes and elastic re-meshing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mp", [1, 8, 16])
def test_plan_mesh_equals_the_reference(mp):
    for n in range(1, 1025):
        try:
            want = ref_elastic.plan_mesh(n, model_parallel=mp)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                plan_mesh(n, model_parallel=mp)
            continue
        got = plan_mesh(n, model_parallel=mp)
        assert dataclasses.astuple(got) == dataclasses.astuple(want), n


@pytest.mark.parametrize("arch", ["llama32_1b", "deepseek_v3_671b", "mamba2_2p7b",
                                  "musicgen_large"])
def test_reshard_plan_equals_the_reference(arch):
    old, new = plan_mesh(512), plan_mesh(496)
    ducks = [types.SimpleNamespace(axis_names=p.axis_names,
                                   shape=dict(zip(p.axis_names, p.shape))) for p in (old, new)]
    ref = ref_leaves(ref_elastic.reshard_plan(
        ref_steps.abstract_params(ref_registry.get_config(arch)), *ducks))
    # the reference's pairs flatten to their specs: (path/0, old) and (path/1, new)
    pairs = rules.leaves_with_path(
        reshard_plan(steps.abstract_params(registry.get_config(arch)), old, new))
    assert {f"{ref_path(path)}/{k}" for path, _ in pairs for k in "01"} == set(ref)
    for path, (o, n) in pairs:
        rp = ref_path(path)
        stacked = rp.split("/")[0] in STACKED
        for got, key in ((o, "0"), (n, "1")):
            want = norm(ref[f"{rp}/{key}"])
            assert norm(got) == (want[1:] if stacked else want), path


def test_meshes_raise_without_cuda(monkeypatch):
    """No card and no ``device=``: ``make_host_mesh`` and ``build_mesh``
    raise; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_host_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_mesh(MeshPlan((1, 1), ("data", "model"), 1, 0))
    with pytest.raises(RuntimeError, match="process group of 8 ranks"):
        build_mesh(plan_mesh(8, model_parallel=2), device_type="cpu")


HOST_MESH = """
import torch, torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from repro_torch.configs import registry
from repro_torch.ft import reshard_plan
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.sharding import rules
mesh = make_host_mesh("cpu")
assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
params = T.init_params(0, registry.get_config("llama32_1b", smoke=True), device="cpu")
shardings = dict(rules.leaves_with_path(rules.param_shardings(params, mesh)))
for path, p in rules.leaves_with_path(params):
    local = distribute_tensor(p, mesh, shardings[path]).to_local()
    assert local.shape == p.shape and torch.equal(local, p), path
assert all(o == n for _, (o, n) in rules.leaves_with_path(reshard_plan(params, mesh, mesh)))
dist.destroy_process_group()
print("ok")
"""


def test_host_mesh_on_the_cpu_distributes_bit_equal():
    res = subprocess.run([sys.executable, "-c", HOST_MESH], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")


# ---------------------------------------------------------------------------
# the shard router, the paper's config, input specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,hosts,seed", [(64, 8, 7), (200, 3, 1), (513, 16, 2),
                                          (1000, 64, 3), (5, 8, 4)])
def test_route_shards_equals_the_reference(n, hosts, seed):
    mbrs = datasets.uniform_squares(n, seed=seed, side=30.0)
    assert np.array_equal(mbrs, ref_datasets.uniform_squares(n, seed=seed, side=30.0))
    got = route_shards(mbrs, hosts)
    assert got == ref_router.route_shards(mbrs, hosts)
    assert sorted(i for ids in got.values() for i in ids) == list(range(n))
    if n >= 64:  # the reference test's spatial coherence
        areas = [M.area(M.merge_many(mbrs[ids])) for ids in got.values() if ids]
        assert np.mean(areas) < 0.5 * M.area(M.merge_many(mbrs))


def test_paper_spatial_equals_the_reference():
    assert dataclasses.asdict(paper_spatial.config()) == dataclasses.asdict(ref_paper.config())
    assert ([f.name for f in dataclasses.fields(paper_spatial.SpatialConfig)]
            == [f.name for f in dataclasses.fields(ref_paper.SpatialConfig)])


def assert_inputs_equal(got: dict, want: dict) -> None:
    """``input_specs`` of both packages: the same keys; batches, tokens and
    ``pos`` of equal shapes and dtypes; caches through the C24 transpose,
    list indices dropped, stacked lead removed; every port tensor on
    ``meta``."""
    assert set(got) == set(want)
    for key in got:
        ref = ref_leaves(want[key])
        port = rules.leaves_with_path(got[key])
        assert len(port) >= len(ref)
        for path, leaf in port:
            assert leaf.device.type == "meta"
            rp = ref_path(path)
            rshape = tuple(ref[rp].shape)
            if key == "caches":
                rshape = rshape if rp.startswith("tail") else rshape[1:]
                if rp.split("/")[-1] in ("k", "v"):
                    rshape = (rshape[0], rshape[2], rshape[1], rshape[3])
            assert tuple(leaf.shape) == rshape, (key, path)
            assert str(leaf.dtype).removeprefix("torch.") == str(ref[rp].dtype), (key, path)


@pytest.mark.parametrize("shape", list(registry.SHAPES))
@pytest.mark.parametrize("arch", registry.ARCHS)
def test_input_specs_equal_the_reference(arch, shape):
    assert_inputs_equal(registry.input_specs(registry.get_config(arch), shape),
                        ref_registry.input_specs(ref_registry.get_config(arch), shape))


@pytest.mark.parametrize("arch,shape,b,s", [("llama32_1b", "train_4k", 8, 1024),
                                            ("internvl2_2b", "prefill_32k", 2, 4096),
                                            ("musicgen_large", "decode_32k", 3, 8192),
                                            ("mamba2_2p7b", "long_500k", 2, 1024),
                                            ("recurrentgemma_9b", "train_4k", 4, 512)])
def test_input_specs_overrides_equal_the_reference(arch, shape, b, s):
    assert_inputs_equal(
        registry.input_specs(registry.get_config(arch), shape, global_batch=b, seq_len=s),
        ref_registry.input_specs(ref_registry.get_config(arch), shape, global_batch=b,
                                 seq_len=s))
