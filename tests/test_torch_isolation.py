"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor the JAX package ``repro``, and the port never falls
back to the CPU unless asked to."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import SpatialIndex, convert
from repro_torch.checkpoint import DurableIndex
from repro_torch.launch.spatial_serve import SpatialServer
from repro_torch.core import kvindex
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_repro(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_runs_with_jax_and_repro_unimportable():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import numpy as np\n"
        "from repro_torch import SpatialIndex\n"
        "from repro_torch.core import datasets\n"
        "d = datasets.uniform_squares(300, seed=4)\n"
        "q = datasets.region_queries(d, 4, seed=4)\n"
        "for p in ('float32', 'compact'):\n"
        "    r = SpatialIndex.build(d, structure='pyramid', build='device', precision=p,\n"
        "                           device='cpu').region(q)\n"
        "    assert r.hits.shape == (4, 300) and int(r.counts.sum()) > 0\n"
        "    s = SpatialIndex.build(d, structure='pyramid', precision=p, stream=True,\n"
        "                           device='cpu')\n"
        "    assert s.region(q).hits.equal(r.hits)\n"
        "    live = SpatialIndex.build(d, structure='pyramid', precision=p, device='cpu',\n"
        "                              capacity=8)\n"
        "    live.insert(d[:3]); live.delete([0]); live.flush()\n"
        "    assert live.region(q).hits.shape == (4, live.id_space)\n"
        "    j = live.join(r := SpatialIndex.build(d[:50], device='cpu'))\n"
        "    assert j.pairs.shape == (live.id_space, 50) and j.n_pairs > 0\n"
        "    nn = live.knn(q[:, :2], 3)\n"
        "    assert nn.ids.shape == (4, 3) and bool((nn.dists[:, 1:] >= nn.dists[:, :-1]).all())\n"
        "import torch\n"
        "from repro_torch.core import kvindex\n"
        "from repro_torch.kernels import ops\n"
        "g = torch.Generator().manual_seed(0)\n"
        "keys, probe = torch.randn(1024, 16, generator=g), torch.randn(16, generator=g)\n"
        "ix = kvindex.build_kv_index(keys, probe, 128, 4)\n"
        "ids = kvindex.select_blocks_batched(ix.block_mbr, ix.pyramid,\n"
        "    kvindex.query_region(keys[-2:], probe, 1000), 3)\n"
        "assert ids.shape == (2, 3) and ids.dtype == torch.int32\n"
        "kb = keys.reshape(1, 8, 128, 16).expand(2, -1, -1, -1).contiguous()\n"
        "o = ops.mqr_sparse_attention(keys[-2:].contiguous(), kb, kb, ids, 999)\n"
        "x = ops.flash_attention(kb[:, :1, :, :].reshape(2, 128, 16).contiguous(),\n"
        "    kb[:, 1].contiguous(), kb[:, 2].contiguous())\n"
        "n = ops.rmsnorm(keys, probe)\n"
        "assert o.shape == (2, 16) and x.shape == (2, 128, 16) and n.shape == keys.shape\n"
        "import tempfile\n"
        "from repro_torch.checkpoint import DurableIndex, live_ids\n"
        "from repro_torch.ft import FaultPlan\n"
        "from repro_torch.obs import trace\n"
        "trace.enable()\n"
        "with tempfile.TemporaryDirectory() as root:\n"
        "    dur = DurableIndex.create(d, root, structure='pyramid', device='cpu', sync=False,\n"
        "                              capacity=8)\n"
        "    dur.insert(d[:3]); dur.delete([0]); dur.checkpoint(); dur.flush(); dur.close()\n"
        "    back = DurableIndex.recover(root, backend='serve', device='cpu', sync=False)\n"
        "    assert (live_ids(back) == live_ids(dur)).all()\n"
        "    back.index.bind_fault_plan(FaultPlan(fail_launches=3))\n"
        "    import warnings\n"
        "    with warnings.catch_warnings():\n"
        "        warnings.simplefilter('ignore')\n"
        "        assert back.region(q).hits.equal(dur.region(q).hits)\n"
        "    assert back.stats.rung_dispatches == {'torch': 1}\n"
        "assert any(e['name'] == 'serve.rung' for e in trace.get_tracer().events())\n"
        "from repro_torch.launch.train import train\n"
        "with tempfile.TemporaryDirectory() as ck:\n"
        "    losses = train(steps=3, batch=2, seq=16, d_model=32, n_layers=1, log_every=0,\n"
        "                   ckpt_dir=ck, ckpt_every=2, grad_compress=True, device='cpu')\n"
        "assert losses.shape == (3,) and np.isfinite(losses).all()\n"
        "from repro_torch.data import route_shards\n"
        "assign = route_shards(datasets.uniform_squares(64, seed=7, side=30.0), 8)\n"
        "assert sorted(i for ids in assign.values() for i in ids) == list(range(64))\n"
        "from repro_torch.launch import dryrun\n"
        "full = dryrun.registry.get_config\n"
        "dryrun.registry.get_config = lambda arch, smoke=False: full(arch, smoke=True)\n"
        "import contextlib, io\n"
        "with tempfile.TemporaryDirectory() as out, contextlib.redirect_stdout(io.StringIO()):\n"
        "    rec = dryrun.run_cell('llama32_1b', 'decode_32k', 'card', out, ['head_dim=64'],\n"
        "                          global_batch=2, seq_len=256, tag='sparse')\n"
        "assert rec['cost']['kernels']['mqr_sparse_attention'][0] > 0\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """With no card and no explicit CPU request, nothing runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = np.array([[0.0, 0.0, 1.0, 1.0], [2.0, 2.0, 3.0, 3.0]])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpatialIndex.build(data)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.device_schedule(data)
    with pytest.raises(RuntimeError):
        ops.resolve_device("cuda")
    sched = ops.device_schedule(data, device="cpu")
    fields = {f: getattr(sched, f).numpy() if isinstance(getattr(sched, f), torch.Tensor)
              else getattr(sched, f) for f in sched.__dataclass_fields__}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.schedule_from_numpy(fields)
    kv = {"block_mbr": np.zeros((4, 4), np.float32),
          "pyramid": {"group_of": np.zeros((2, 4), np.int32),
                      "group_mbr": np.zeros((2, 4, 4), np.float32), "levels": 2}}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.kvindex_from_numpy(kv)
    inc = {"block_mbr": kv["block_mbr"], "group_of": kv["pyramid"]["group_of"],
           "group_mbr": kv["pyramid"]["group_mbr"]}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.inc_kvindex_from_numpy(inc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kvindex.init_incremental(4, 128, 2)
    assert convert.kvindex_from_numpy(kv, device="cpu").block_mbr.device.type == "cpu"
    # asked for explicitly, the CPU works
    assert SpatialIndex.build(data, device="cpu").device == torch.device("cpu")
    # the durability and serving entry points follow the same rule
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpatialIndex.build(data, backend="serve")
    assert SpatialIndex.build(data, backend="serve", device="cpu").region(data).hits.shape == (2, 2)
    SpatialIndex.build(data, device="cpu").save(tmp_path / "snap")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpatialIndex.load(tmp_path / "snap")
    assert SpatialIndex.load(tmp_path / "snap", device="cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DurableIndex.create(data, tmp_path / "d0", sync=False)
    DurableIndex.create(data, tmp_path / "d", device="cpu", sync=False).close()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DurableIndex.recover(tmp_path / "d", sync=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DurableIndex.open(tmp_path / "d", sync=False)
    assert DurableIndex.recover(tmp_path / "d", device="cpu", sync=False).n_objects == 2
    assert DurableIndex.open(tmp_path / "d", device="cpu", sync=False).n_objects == 2
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpatialServer(sched)
    hits, _ = SpatialServer(sched, device="cpu").search(data)
    assert hits.device == torch.device("cpu") and hits.shape == (2, 2)


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Without a card chip_smoke.py exits nonzero and prints no result; in
    a directory holding nothing else of the repository it fails too."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        res = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout
