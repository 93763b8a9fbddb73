"""The port's dry run, cost counter and roofline (``launch.op_cost``,
``launch.dryrun``, ``launch.roofline``) and the kernels' ``meta`` branches
and cost reports, on the CPU.

``OpCost`` must count the same FLOPs and bytes for a step on ``meta`` and
on CPU tensors (the card's run is held to ``meta`` in ``chip_smoke.py``);
the kernels report once a call, their plain ops not counted; ``run_cell``
writes the reference's record keys with the reference's model FLOPs; and
``roofline.analyze`` is the reference's ``analyze`` with its three
constants set to the H100's.  The smoke configs take head dim 64, a head
dim kernel #8 is built for (``meta`` runs the card's checks).
"""
import dataclasses
import json
import math

import pytest
import torch

from repro.configs import registry as ref_registry
from repro.launch import roofline as ref_roofline
from repro_torch.configs import registry
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import mqr_sparse_attention as sparse_mod
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as norm_mod
from repro_torch.launch import dryrun, op_cost, roofline, steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_cost import OpCost
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.sharding import rules

REF_KEYS = {"arch", "shape", "mesh", "n_devices", "kind", "params", "active_params",
            "model_flops", "memory", "cost", "collectives", "seq_len", "global_batch", "tag",
            "overrides"}
OVERRIDES = ["head_dim=64"]


def smoke(arch="llama32_1b", **kw):
    return dataclasses.replace(registry.get_config(arch, smoke=True), head_dim=64, **kw)


@pytest.fixture
def smoke_configs(monkeypatch):
    """``run_cell`` and the CLI on the archs' smoke configs."""
    full = registry.get_config
    monkeypatch.setattr(registry, "get_config", lambda arch, smoke=False: full(arch, smoke=True))


def cpu_args(cfg, shape, b, s):
    """The step's arguments as CPU tensors, in ``dryrun.step_fn``'s order."""
    kind = registry.SHAPES[shape]["kind"]
    params = T.init_params(0, cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=g, dtype=torch.int32)
    if kind == "train":
        state = adamw.init_state(params, dryrun.opt_config(cfg))
        return params, state, {"tokens": toks, "labels": toks.roll(-1, 1)}
    if kind == "prefill":
        return params, {"tokens": toks}
    caches = T.init_caches(cfg, b, s, device="cpu")
    for layer in caches["all"]:
        for name in ("k", "v"):
            layer["l0"][name].normal_(generator=g)
    return params, toks[:, :1].clone(), caches, torch.tensor(s - 5, dtype=torch.int32)


@pytest.mark.parametrize("shape,b,s,tag", [("train_4k", 2, 64, ""), ("prefill_32k", 1, 128, ""),
                                           ("decode_32k", 2, 256, "dense"),
                                           ("decode_32k", 2, 256, "sparse"),
                                           ("train_4k", 2, 128, "remat_dots")])
def test_op_cost_is_equal_on_meta_and_the_cpu(shape, b, s, tag):
    """A train step (remat full, and dots), a prefill and a decode step
    dense and sparse: the same FLOPs, bytes and kernel reports on ``meta``
    as on CPU tensors."""
    cfg = smoke(remat=True, remat_policy="dots" if tag == "remat_dots" else "full")
    kind = registry.SHAPES[shape]["kind"]
    fn = dryrun.step_fn(cfg, shape, tag)
    meta, _ = dryrun.run_step(fn, dryrun.cell_args(cfg, shape, b, s), kind)
    cpu, out = dryrun.run_step(fn, cpu_args(cfg, shape, b, s), kind)
    assert meta.flops > 0 and meta.bytes > 0
    assert (cpu.flops, cpu.bytes) == (meta.flops, meta.bytes)
    assert cpu.kernels == meta.kernels
    assert cpu.live_bytes == meta.live_bytes
    assert meta.peak_bytes >= meta.live_bytes
    names = set(meta.kernels)
    assert "rmsnorm" in names
    if kind == "train":
        assert {"flash_attention", "flash_attention_bwd", "rmsnorm_bwd"} <= names
    if tag == "sparse":
        assert meta.kernels["mqr_sparse_attention"][0] == cfg.n_layers


def test_matmul_flops_and_bytes_equal_a_hand_count():
    a, b = torch.empty((6, 10), device="meta"), torch.empty((10, 7), device="meta")
    x, y = torch.empty((3, 5, 4)), torch.empty((3, 4, 2))
    with OpCost() as cost:
        a @ b
    assert cost.flops == 2 * 6 * 10 * 7
    assert cost.bytes == 4 * (6 * 10 + 10 * 7 + 6 * 7)
    with OpCost() as cost:
        torch.einsum("bij,bjk->bik", x, y)
        x.transpose(1, 2).reshape(3, 20)  # a copy: bytes, no FLOPs
        x.view(15, 4)  # a view: nothing
    assert cost.flops == 2 * 3 * 5 * 4 * 2
    assert cost.bytes == 4 * (60 + 24 + 30) + 4 * 120
    assert dict(cost.by_op()["flops"]) == {"bmm": 240}


def test_in_place_scatter_counts_what_it_writes():
    cache = torch.zeros((2, 4, 1024, 8))
    new = torch.ones((2, 4, 1, 8))
    at = torch.tensor([5])
    with OpCost() as cost:
        cache.index_copy_(2, at, new)
    assert cost.bytes == 8 + 2 * new.numel() * 4


def test_peak_bytes_is_exact_on_a_hand_built_sequence():
    keep = torch.empty(1000, device="meta")  # 4,000 bytes: one 4,096-byte block
    with OpCost(live={"keep": keep}) as cost:
        a = torch.empty(3000, device="meta")       # 12,288 bytes (12,000 rounded)
        b = torch.empty(10, device="meta")         # 512
        v = a[5:]                                  # a view: the same storage
        del a                                      # the view keeps it
        c = torch.empty(100_000, device="meta")    # 400,384
        del v, c                                   # 12,288 and 400,384 freed
        d = torch.empty((2, 64), device="meta")    # 512
        e = d + 1                                  # 512
    assert cost.live_bytes == 4096
    assert cost.peak_bytes == 4096 + 12_288 + 512 + 400_384
    assert cost.current_bytes == 4096 + 512 + 512 + 512
    assert dict(cost.peak_by_op) == {"arguments": 4096, "empty": 12_288 + 512 + 400_384}
    del b, d, e


def _kernel_calls(dev):
    g = torch.Generator().manual_seed(3)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype).to(dev)

    q, k, v, do = (rnd(4, 128, 64, dtype=torch.bfloat16) for _ in range(4))
    lse = rnd(4, 128)
    x, sc, dy = rnd(6, 256), rnd(256), rnd(6, 256)
    qd, kb, vb = rnd(8, 64), rnd(2, 16, 32, 64), rnd(2, 16, 32, 64)
    ids = torch.randint(0, 16, (8, 5), generator=g, dtype=torch.int32).to(dev)
    return {
        "flash_attention": (lambda: ops.flash_attention(q, k, v),
                            2 * 4 * 128 * 129 * 64, 2 * 4 * 4 * 128 * 64),
        "flash_attention_lse": (lambda: ops.flash_attention_lse(q, k, v),
                                2 * 4 * 128 * 129 * 64, 2 * 4 * 4 * 128 * 64 + 4 * 4 * 128),
        "flash_attention_bwd": (lambda: ops.flash_attention_bwd(q, k, v, lse, do),
                                5 * 4 * 128 * 129 * 64, 2 * 7 * 4 * 128 * 64 + 4 * 4 * 128),
        "rmsnorm": (lambda: ops.rmsnorm(x, sc), 0, 4 * (2 * 6 * 256 + 256)),
        "rmsnorm_bwd": (lambda: ops.rmsnorm_bwd(x, sc, dy), 0, 4 * (3 * 6 * 256 + 2 * 256)),
        "mqr_sparse_attention": (lambda: ops.mqr_sparse_attention(qd, kb, vb, ids, 400, group=4),
                                 4 * 8 * 5 * 32 * 64, 4 * (2 * 8 * 64 + 2 * 8 * 5 * 32 * 64)),
    }


@pytest.mark.parametrize("name", list(_kernel_calls("cpu")))
@pytest.mark.parametrize("dev", ["cpu", "meta"])
def test_each_kernel_reports_once_and_its_plain_ops_are_not_counted(name, dev, monkeypatch):
    call, flops, nbytes = _kernel_calls(dev)[name]
    if dev == "meta":  # no plain version runs on meta
        for mod in (fa_mod, norm_mod, sparse_mod):
            for attr in [a for a in vars(mod) if a.endswith("_torch")]:
                monkeypatch.setattr(mod, attr, None)
    with OpCost() as cost:
        out = call()
    report = name.removesuffix("_lse")
    assert cost.kernels == {report: [1, flops, nbytes]}
    assert (cost.flops, cost.bytes) == (flops, nbytes)
    for t in out if isinstance(out, tuple) else (out,):
        assert t.device.type == dev


def test_meta_branches_run_the_cards_checks():
    q = torch.empty((2, 128, 16), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="built for D"):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="built for D"):
        ops.flash_attention_bwd(q, q, q, torch.empty((2, 128), device="meta"), q)
    kb = torch.empty((1, 4, 8, 300), device="meta")
    with pytest.raises(ValueError, match="up to 256"):
        ops.mqr_sparse_attention(torch.empty((2, 300), device="meta"), kb, kb,
                                 torch.zeros((2, 1), dtype=torch.int32, device="meta"), 5,
                                 group=2)
    w = fa_mod.bwd_workspace_elements(256, 1000)
    assert w == 2 * 256 * 1024


ARCH_CELLS = [(a, s) for a in registry.ARCHS for s in registry.SHAPES]
CELL_SIZE = {"train_4k": (2, 64), "prefill_32k": (1, 64), "decode_32k": (2, 256),
             "long_500k": (1, 256)}


@pytest.mark.parametrize("arch,shape", ARCH_CELLS)
def test_run_cell_writes_the_reference_keys(arch, shape, tmp_path, smoke_configs):
    b, s = CELL_SIZE[shape]
    rec = dryrun.run_cell(arch, shape, "card", tmp_path, OVERRIDES, global_batch=b, seq_len=s)
    on_disk = json.loads((tmp_path / f"{arch}__{shape}__card.json").read_text())
    assert on_disk == json.loads(json.dumps(rec))
    ref_cfg = dataclasses.replace(ref_registry.get_config(arch, smoke=True), head_dim=64)
    kind = registry.SHAPES[shape]["kind"]
    assert REF_KEYS <= set(rec)
    assert (rec["params"], rec["active_params"]) == (ref_cfg.param_count(),
                                                     ref_cfg.active_param_count())
    n = ref_cfg.active_param_count()
    want = {"train": 6 * n * b * s, "prefill": 2 * n * b * s, "decode": 2 * n * b}[kind]
    assert rec["model_flops"] == want
    assert rec["cost"]["flops_per_device"] > 0 and rec["cost"]["bytes_accessed_per_device"] > 0
    mem = rec["memory"]
    assert mem["peak_bytes_per_device"] >= mem["argument_bytes_per_device"] > 0
    assert rec["collectives"]["total_wire_bytes"] == 0
    if kind == "train":
        assert rec["moments_dtype"] == "float32"
    if kind == "decode":
        has_kv = any(k in ("attn", "mla") for k in ref_cfg.block_pattern + ref_cfg.tail_pattern)
        assert rec["mqr_sparse"] == (shape == "long_500k" and has_kv)


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("arch", ["llama32_1b", "granite_moe_1b", "deepseek_v3_671b",
                                  "internvl2_2b"])
def test_production_meshes_record_argument_bytes_per_device(arch, mesh_name, tmp_path):
    # the one path that does not run sharded yet, the mqr-KV sparse decode
    # (long_500k of an arch with kv attention, ROADMAP A4d): its record keeps
    # the rules' argument bytes
    rec = dryrun.run_cell(arch, "long_500k", mesh_name, tmp_path, force=True)
    assert rec["mqr_sparse"] and not dryrun.runs_sharded(registry.get_config(arch), "long_500k")
    assert rec["cost"] is None and rec["collectives"] is None and "A4d" in rec["note"]
    assert rec["n_devices"] == (256 if mesh_name == "single" else 512)
    mem = rec["memory"]
    parts = [v for k, v in mem.items() if k not in ("argument_bytes_per_device",
                                                    "peak_bytes_per_device")]
    assert mem["argument_bytes_per_device"] == sum(parts) > 0
    assert mem["peak_bytes_per_device"] is None
    mesh = make_production_mesh(multi_pod=mesh_name == "multi")
    elements = [math.prod(rules.shard_shape(rules.spec_for_param(path, t.shape, mesh), t.shape,
                                            mesh)) for path, t in rules.leaves_with_path(
        steps.abstract_params(registry.get_config(arch)))]
    assert sum(elements) * 2 < mem["params_bytes_per_device"] < sum(elements) * 4


def test_roofline_analyze_equals_the_reference_with_the_h100_constants(monkeypatch, tmp_path,
                                                                       smoke_configs):
    for arch, shape in (("llama32_1b", "train_4k"), ("gemma_2b", "decode_32k"),
                        ("mamba2_2p7b", "prefill_32k")):
        b, s = CELL_SIZE[shape]
        dryrun.run_cell(arch, shape, "card", tmp_path, OVERRIDES, global_batch=b, seq_len=s)
    cells = roofline.load_cells(str(tmp_path))
    cells.append(dict(cells[0], n_devices=256, collectives={"total_wire_bytes": 3e9}))
    monkeypatch.setattr(ref_roofline, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(ref_roofline, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(ref_roofline, "LINK_BW", roofline.LINK_BW)
    assert len(cells) == 4
    for c in cells:
        assert roofline.analyze(c) == ref_roofline.analyze(c)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 450e9)


def test_the_clis_on_the_cpu(tmp_path, capsys, smoke_configs):
    dryrun.main(["--arch", "llama32_1b", "--shape", "decode_32k", "--mesh", "card,single",
                 "--override", "head_dim=64", "--batch", "2", "--seq", "512",
                 "--tag", "sparse", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "llama32_1b__decode_32k__card__sparse.json").read_text())
    assert rec["mqr_sparse"] and rec["cost"]["kernels"]["mqr_sparse_attention"][0] > 0
    roofline.main(["--dir", str(tmp_path), "--tag", "sparse"])
    out = capsys.readouterr().out
    assert "| llama32_1b | decode_32k | card |" in out and "fits per device" in out
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "no_such_arch", "--shape", "train_4k", "--out", str(tmp_path)])


def test_storage_bytes_rounds_to_the_allocators_blocks():
    assert [op_cost.storage_bytes(n) for n in (0, 1, 512, 513)] == [0, 512, 512, 1024]
