"""The sharded step (DTensor over a ``DeviceMesh``) held to the JAX package's
sharded step on the CPU.

- **Train, prefill, decode.**  The smoke llama (float32) on four gloo ranks
  over a (2, 2) ``("data", "model")`` mesh (``launch.steps.place`` with the
  rules' placements) against the reference jitted with ``in_shardings``
  on a (2, 2) mesh of four forced host devices, both in subprocesses
  started together, from the same parameters (the reference's
  ``init_params``, carried across by ``convert``): three
  ``make_train_step`` steps with remat off, ``"full"`` and ``"dots"`` (loss,
  grad_norm, lr and every final parameter within 1e-4, relative and
  absolute, as ``test_torch_train``'s five unsharded steps), the prefill
  logits (1e-4) and six greedy decode tokens (equal); the same ranks as a
  (1, 4) mesh (one query head a rank, the decode caches' sequence sharded)
  for the train step and the decode tokens.
- **``modules.shard``** on a DTensor gives the placements of the
  reference's cleaned spec (the output sharding of ``jax.jit(lambda x:
  shard(x, *spec))`` under the reference's mesh) on a (4, 2) and a
  (2, 2, 2) mesh, and is the identity on a plain tensor.
- **``OpCost`` under DTensor**, counted by hand on one FSDP/TP linear,
  with DTensor's sharding propagation left out of the peak.
- **Paths that do not run sharded yet** (any mixer but ``attn``, the MoE
  FFN, the frontends) raise ``NotImplementedError`` on DTensors.
- **The dry run on the production meshes** (fake process groups of 256
  and 512 ranks, ``meta`` shards): non-null per-device cost, peak and
  collectives with the reference's keys, argument bytes equal to the
  rules' ``shard_shape``, and per-device FLOPs x devices no less than one
  card's.

The two runs of the first bullet are made once a test session (under xdist,
once for all workers: a file lock in the session's temporary root).
"""
import dataclasses
import fcntl
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import registry as ref_registry
from repro.models import transformer as ref_T
from repro.optim import adamw as ref_adamw
from repro_torch.configs import registry
from repro_torch.launch import dryrun
from repro_torch.launch.op_cost import COLL_OPS, OpCost
from repro_torch.models.modules import shard
from repro_torch.sharding import rules

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
TOL = 1e-4
REMATS = {"off": dict(remat=False), "full": dict(remat=True, remat_policy="full"),
          "dots": dict(remat=True, remat_policy="dots")}
STEPS, SEQ, BATCH = 3, 16, 4
DECODE_STEPS, MAX_LEN = 6, 32
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=5)
# (mesh axis names, sizes, tensor shape, spec) for the shard() check
SHARD_CASES = [
    (("data", "model"), (4, 2), (8, 6, 4), (("pod", "data"), "model", None)),
    (("data", "model"), (4, 2), (8, 6, 4), (("pod", "data"), None, "model")),
    (("data", "model"), (4, 2), (6, 3, 4), (("pod", "data"), "model", None)),
    (("data", "model"), (4, 2), (8, 16, 6), (("pod", "data"), None, "model")),
    (("data", "model"), (4, 2), (8, 16), ("model", ("pod", "data"))),
    (("pod", "data", "model"), (2, 2, 2), (8, 6, 4), (("pod", "data"), "model", None)),
    (("pod", "data", "model"), (2, 2, 2), (2, 6, 4), (("pod", "data"), "model", None)),
    (("pod", "data", "model"), (2, 2, 2), (8, 4, 3), (("pod", "data"), None, "model")),
    (("pod", "data", "model"), (2, 2, 2), (6, 4, 8), ("data", "model", ("pod",))),
]


def cfg_pair(**over):
    over = dict(dtype="float32", **over)
    return (dataclasses.replace(ref_registry.get_config("llama32_1b", smoke=True), **over),
            dataclasses.replace(registry.get_config("llama32_1b", smoke=True), **over))


REF = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import registry
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.launch import steps
from repro.models import transformer as T
from repro.models.modules import shard
from repro.optim import adamw
from repro.sharding import rules
d = pickle.load(open(sys.argv[1], "rb"))
base = dataclasses.replace(registry.get_config("llama32_1b", smoke=True), dtype="float32")
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
tree = lambda t: jax.tree.map(np.asarray, t)
out = {"train": {}}
with mesh:
    for name, over in d["remats"].items():
        cfg = dataclasses.replace(base, **over)
        ocfg = adamw.AdamWConfig(**d["opt"])
        params = jax.tree.map(jnp.asarray, d["params"])
        state = adamw.init_state(params, ocfg)
        psh = rules.param_shardings(params, mesh)
        osh = adamw.AdamWState(step=NamedSharding(mesh, P()), m=psh, v=psh)
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=d["seq"],
                                      global_batch=d["batch"]))
        bsh = rules.batch_shardings({k: jnp.asarray(v) for k, v in data.batch(0).items()}, mesh)
        step = jax.jit(steps.make_train_step(cfg, ocfg), in_shardings=(psh, osh, bsh))
        metrics = []
        for i in range(d["steps"]):
            b = {k: jnp.asarray(v) for k, v in data.batch(i).items()}
            params, state, m = step(params, state, b)
            metrics.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
        out["train"][name] = {"metrics": metrics, "params": tree(params)}
    cfg = base
    params = jax.tree.map(jnp.asarray, d["params"])
    psh = rules.param_shardings(params, mesh)
    batch = {"tokens": jnp.asarray(d["prompt"])}
    pre = jax.jit(steps.make_prefill_step(cfg),
                  in_shardings=(psh, rules.batch_shardings(batch, mesh)))
    out["prefill"] = np.asarray(pre(params, batch))
    caches = T.init_caches(cfg, d["prompt"].shape[0], d["max_len"])
    tok = jnp.asarray(d["prompt"][:, :1])
    serve = jax.jit(steps.make_serve_step(cfg), in_shardings=(
        psh, NamedSharding(mesh, rules.batch_spec(tok.shape, mesh)),
        rules.cache_shardings(caches, mesh), NamedSharding(mesh, P())))
    toks = []
    for i in range(d["decode_steps"]):
        tok, caches = serve(params, tok, caches, jnp.asarray(i, jnp.int32))
        toks.append(np.asarray(tok))
    out["decode"] = np.stack(toks)
specs = []
for names, sizes, shape, spec in d["shard_cases"]:
    m = Mesh(np.array(jax.devices()[:int(np.prod(sizes))]).reshape(sizes), names)
    with m:
        y = jax.jit(lambda x: shard(x, *spec))(jnp.zeros(shape, jnp.float32))
    specs.append([list(e) if isinstance(e, tuple) else e for e in y.sharding.spec])
out["shard_specs"] = specs
pickle.dump(out, open(sys.argv[2], "wb"))
"""

PORT = """
import dataclasses, pickle, sys
import numpy as np
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import steps
from repro_torch.models import transformer as T
from repro_torch.models.modules import tree_leaves
from repro_torch.optim import AdamWConfig
from repro_torch.sharding import rules
rank = int(sys.argv[3])
dist.init_process_group("gloo", init_method=f"file://{sys.argv[4]}", rank=rank, world_size=4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
d = pickle.load(open(sys.argv[1], "rb"))
base = dataclasses.replace(registry.get_config("llama32_1b", smoke=True), dtype="float32")
full = lambda t: t.full_tensor().detach().numpy()
out = {"train": {}}
for name, over in d["remats"].items():
    cfg = dataclasses.replace(base, **over)
    params = convert.params_from_numpy(d["params"], cfg, device="cpu")
    state = convert.opt_state_from_numpy(d["opt_state"], cfg, device="cpu")
    state = steps.place_opt_state(state, params, mesh)
    params = steps.place(params, rules.param_shardings(params, mesh), mesh)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=d["seq"],
                                  global_batch=d["batch"]))
    step = steps.make_train_step(cfg, AdamWConfig(**d["opt"]))
    metrics = []
    for i in range(d["steps"]):
        b = {k: torch.from_numpy(v) for k, v in data.batch(i).items()}
        params, state, m = step(params, state, steps.place(b, rules.batch_shardings(b, mesh), mesh))
        metrics.append({k: float(m[k].full_tensor()) for k in ("loss", "grad_norm", "lr")})
    out["train"][name] = {"metrics": metrics, "params": [full(p) for p in tree_leaves(params)],
                          "types": sorted({type(p).__name__ for p in tree_leaves(params)})}
cfg = base
params = convert.params_from_numpy(d["params"], cfg, device="cpu")
params = steps.place(params, rules.param_shardings(params, mesh), mesh)
batch = {"tokens": torch.from_numpy(d["prompt"])}
with torch.inference_mode():
    logits = steps.make_prefill_step(cfg)(params, steps.place(
        batch, rules.batch_shardings(batch, mesh), mesh))
out["prefill"] = full(logits)
caches = T.init_caches(cfg, d["prompt"].shape[0], d["max_len"], device="cpu")
caches = steps.place(caches, rules.cache_shardings(caches, mesh), mesh)
out["cache_placements"] = sorted({str(c.placements) for c in tree_leaves(caches)})
tok = {"t": torch.from_numpy(d["prompt"][:, :1])}
tok = steps.place(tok, rules.batch_shardings(tok, mesh), mesh)["t"]
serve = steps.make_serve_step(cfg)
toks = []
with torch.inference_mode():
    for i in range(d["decode_steps"]):
        tok, caches = serve(params, tok, caches, torch.tensor(i, dtype=torch.int32))
        toks.append(full(tok))
out["decode"] = np.stack(toks)
out["cache_types"] = sorted({type(c).__name__ for c in tree_leaves(caches)})
# a (1, 4) mesh: one query head a rank and the two kv heads replicated
# (GQA by global head index), the decode caches' sequence over model
# (the flash-decoding combine)
mesh4 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
cfg = base
params = convert.params_from_numpy(d["params"], cfg, device="cpu")
state = steps.place_opt_state(convert.opt_state_from_numpy(d["opt_state"], cfg, device="cpu"),
                              params, mesh4)
params = steps.place(params, rules.param_shardings(params, mesh4), mesh4)
data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=d["seq"],
                              global_batch=d["batch"]))
step = steps.make_train_step(cfg, AdamWConfig(**d["opt"]))
metrics = []
for i in range(d["steps"]):
    b = {k: torch.from_numpy(v) for k, v in data.batch(i).items()}
    params, state, m = step(params, state, steps.place(b, rules.batch_shardings(b, mesh4), mesh4))
    metrics.append({k: float(m[k].full_tensor()) for k in ("loss", "grad_norm", "lr")})
out["train_1x4"] = {"metrics": metrics, "params": [full(p) for p in tree_leaves(params)]}
params = convert.params_from_numpy(d["params"], cfg, device="cpu")
params = steps.place(params, rules.param_shardings(params, mesh4), mesh4)
caches = T.init_caches(cfg, d["prompt"].shape[0], d["max_len"], device="cpu")
caches = steps.place(caches, rules.cache_shardings(caches, mesh4), mesh4)
out["cache_placements_1x4"] = sorted({str(c.placements) for c in tree_leaves(caches)})
tok = {"t": torch.from_numpy(d["prompt"][:, :1])}
tok = steps.place(tok, rules.batch_shardings(tok, mesh4), mesh4)["t"]
toks = []
with torch.inference_mode():
    for i in range(d["decode_steps"]):
        tok, caches = serve(params, tok, caches, torch.tensor(i, dtype=torch.int32))
        toks.append(full(tok))
out["decode_1x4"] = np.stack(toks)
# #8 (through causal_attention) and #10 on DTensors: a sequence-sharded
# q / a sharded last dim is redistributed before the call; forward and
# backward against the plain tensors
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.kernels import ops
from repro_torch.models.attention import causal_attention
g = torch.Generator().manual_seed(11)
leaf = lambda t, pl: distribute_tensor(t, mesh, pl).detach().requires_grad_()
err = lambda a, b: float((a.full_tensor() - b).abs().max())
for name, fn, args, pls in (
        ("flash", causal_attention, [torch.randn(2, 16, h, 8, generator=g) for h in (4, 1, 1)],
         [(Shard(0), Shard(1))] * 3),
        ("rmsnorm", lambda x, s: ops.RMSNorm.call(x, s, 1e-6),
         [torch.randn(4, 6, 32, generator=g), torch.rand(32, generator=g) + 0.5],
         [(Shard(2), Shard(1)), (Replicate(), Replicate())])):
    plain = [a.clone().requires_grad_() for a in args]
    want = fn(*plain)
    want.sum().backward()
    dist_args = [leaf(a, pl) for a, pl in zip(args, pls)]
    got = fn(*dist_args)
    got.sum().backward()
    out[name] = {"placements": str(got.placements), "out_err": err(got, want),
                 "grad_err": max(err(d.grad, p.grad) for d, p in zip(dist_args, plain))}
if rank == 0:
    pickle.dump(out, open(sys.argv[2], "wb"))
dist.destroy_process_group()
"""


# a rank that raises leaves at once, so that the others, blocked in a
# collective, are killed by ``_run_both`` instead of waiting out its timeout
PORT_GUARDED = ("import os, sys, traceback\ntry:\n" + textwrap.indent(PORT, "    ")
                + "except BaseException:\n    traceback.print_exc()\n    sys.stderr.flush()\n"
                "    os._exit(1)\n")
RUN_TIMEOUT = 240


def _inputs() -> dict:
    """The reference's smoke-llama parameters and AdamW state (numpy), the
    prompt and the run's sizes: what both subprocesses start from."""
    ref_cfg, _ = cfg_pair()
    params = jax.jit(lambda key: ref_T.init_params(key, ref_cfg))(jax.random.PRNGKey(3))
    state = ref_adamw.init_state(params, ref_adamw.AdamWConfig(**OPT))
    tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    prompt = np.random.default_rng(5).integers(0, ref_cfg.vocab_size, (BATCH, SEQ),
                                               dtype=np.int32)
    return {"params": tree(params), "opt_state": tuple(tree(s) for s in state),
            "remats": REMATS, "opt": OPT, "steps": STEPS, "seq": SEQ, "batch": 2,
            "prompt": prompt, "max_len": MAX_LEN, "decode_steps": DECODE_STEPS,
            "shard_cases": SHARD_CASES}


def _run_both(root: pathlib.Path) -> dict:
    """The reference's run and the port's four ranks, started together; the
    ranks meet through a file store (no port to race for).  Each process
    writes its output to a file of its own; when one fails, or the run
    outlasts ``RUN_TIMEOUT``, the others are killed and every process's
    stderr is shown."""
    inputs, ref_out, port_out = root / "in.pkl", root / "ref.pkl", root / "port.pkl"
    inputs.write_bytes(pickle.dumps(_inputs()))
    store = root / "pg_store"
    store.unlink(missing_ok=True)
    cmds = [("ref", [REF, inputs, ref_out])]
    cmds += [(f"rank {r}", [PORT_GUARDED, inputs, port_out, str(r), store]) for r in range(4)]
    procs = []
    for name, argv in cmds:
        log = open(root / f"{name.replace(' ', '')}.log", "w+")
        procs.append((name, log, subprocess.Popen([sys.executable, "-c", *map(str, argv)],
                                                  env=ENV, stdout=log, stderr=log)))
    deadline, timed_out = time.monotonic() + RUN_TIMEOUT, False
    while any(p.poll() is None for _, _, p in procs):
        timed_out = time.monotonic() > deadline
        if timed_out or any(p.returncode for _, _, p in procs):
            for _, _, p in procs:
                p.kill()
                p.wait()
            break
        time.sleep(0.2)
    errs = []
    for name, log, p in procs:
        log.seek(0)
        if p.returncode:
            errs.append(f"--- {name} (exit {p.returncode}) ---\n{log.read()[-3000:]}")
        log.close()
    if timed_out:
        errs.insert(0, f"the sharded runs outlasted {RUN_TIMEOUT} s")
    assert not errs, "\n".join(errs)
    return {"ref": pickle.loads(ref_out.read_bytes()), "port": pickle.loads(port_out.read_bytes())}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sharded runs, made once a session: under xdist every worker's
    temporary root shares a parent, and a lock there lets one worker run
    them while the others wait and read its results, or its failure."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    root = root / "torch_sharded"
    root.mkdir(exist_ok=True)
    done, failed = root / "runs.pkl", root / "failed.txt"
    with open(root / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if failed.exists():
            pytest.fail(f"the sharded runs failed in another worker:\n{failed.read_text()}")
        if not done.exists():
            try:
                done.write_bytes(pickle.dumps(_run_both(root)))
            except BaseException as e:
                failed.write_text(f"{type(e).__name__}: {e}")
                raise
    return pickle.loads(done.read_bytes())


def ref_leaves(tree, cfg):
    """The reference's parameter tree in the port's leaf order."""
    from repro_torch import convert
    from repro_torch.models.modules import tree_leaves

    return [t.numpy() for t in tree_leaves(convert.params_from_numpy(tree, cfg, device="cpu"))]


@pytest.mark.parametrize("remat", list(REMATS))
def test_sharded_train_step_matches_the_reference(runs, remat):
    """Three steps on four gloo ranks, (2, 2) mesh, equal the reference's
    sharded steps: metrics each step and every final parameter (gathered
    with ``full_tensor``) within 1e-4; every parameter stays a DTensor."""
    ref, port = runs["ref"]["train"][remat], runs["port"]["train"][remat]
    assert port["types"] == ["DTensor"]
    for want, got in zip(ref["metrics"], port["metrics"], strict=True):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[key], want[key], rtol=TOL, err_msg=key)
    _, cfg = cfg_pair(**REMATS[remat])
    for got, want in zip(port["params"], ref_leaves(ref["params"], cfg), strict=True):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_sharded_prefill_matches_the_reference(runs):
    got, want = runs["port"]["prefill"], runs["ref"]["prefill"]
    assert got.shape == want.shape == (BATCH, 1, 256)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_sharded_decode_tokens_equal_the_reference(runs):
    """Six greedy steps with the caches placed by ``cache_shardings`` (kv
    heads over ``model``; batch over ``data``) and written in place on
    each rank's shard."""
    port = runs["port"]
    assert port["cache_types"] == ["DTensor"]
    assert port["cache_placements"] == ["(Shard(dim=0), Shard(dim=1))"]
    np.testing.assert_array_equal(port["decode"], runs["ref"]["decode"])
    assert port["decode"].shape == (DECODE_STEPS, BATCH, 1)


def test_sharded_step_on_a_1x4_mesh_matches_the_reference(runs):
    """The same four ranks as a (1, 4) mesh: one query head a rank over the
    two replicated kv heads (each rank picks its kv head by its head's
    global index), three train steps (remat off) within 1e-4 of the
    reference's; the decode caches' sequence over ``model`` (a rank's
    share of the softmax combined across the four) and the greedy tokens
    equal."""
    ref, port = runs["ref"], runs["port"]
    for want, got in zip(ref["train"]["off"]["metrics"], port["train_1x4"]["metrics"],
                         strict=True):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[key], want[key], rtol=TOL, err_msg=key)
    _, cfg = cfg_pair()
    for got, want in zip(port["train_1x4"]["params"], ref_leaves(ref["train"]["off"]["params"],
                                                                  cfg), strict=True):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert port["cache_placements_1x4"] == ["(Shard(dim=0), Shard(dim=2))"]
    np.testing.assert_array_equal(port["decode_1x4"], ref["decode"])


def test_kernel_wrappers_take_dtensors_through_local_map(runs):
    """#8 through ``causal_attention`` on q (B, S, 4, Dh) and k, v (B, S,
    1, Dh) DTensors sharded on B over ``data`` and S over ``model``, and
    #10 (``RMSNorm.call``) on x sharded on its last dim over ``data``:
    each is redistributed to placements its kernel takes before the call
    (q's heads over ``model``, the one kv head replicated and picked by
    global head index; rows only for #10); outputs and every gradient (the
    kv head's and dscale summed over the ranks) equal the plain tensors'
    within 1e-6."""
    flash, norm = runs["port"]["flash"], runs["port"]["rmsnorm"]
    assert flash["placements"] == "(Shard(dim=0), Shard(dim=2))"
    assert norm["placements"] == "(Replicate(), Shard(dim=1))"
    for r in (flash, norm):
        assert r["out_err"] <= 1e-6 and r["grad_err"] <= 1e-6, r


class fake_group:
    """A fake process group of ``world`` ranks (tests only), rank 0."""

    def __init__(self, world: int):
        self.world = world

    def __enter__(self):
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=self.world)
        return self

    def __exit__(self, *exc):
        dist.destroy_process_group()


def meta_dtensor(shape, mesh, placements=None):
    from torch.distributed.tensor import DTensor, Replicate

    placements = placements or (Replicate(),) * mesh.ndim
    spec = rules.PartitionSpec(*[
        tuple(n for n, p in zip(mesh.mesh_dim_names, placements) if p.is_shard(i)) or None
        for i in range(len(shape))])
    local = torch.empty(rules.shard_shape(spec, shape, mesh), device="meta")
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def test_shard_follows_the_reference_spec_cleaning(runs):
    """On a (4, 2) and a (2, 2, 2) mesh (fake groups of 8 ranks), ``shard``
    redistributes a replicated DTensor to the placements of the spec the
    reference's ``shard`` leaves (axes the mesh lacks dropped, dims that do
    not divide replicated), read from JAX's output sharding; on a plain
    tensor it returns the tensor itself."""
    from torch.distributed.device_mesh import init_device_mesh

    x = torch.zeros(3, 4)
    assert shard(x, ("pod", "data"), "model") is x
    with fake_group(8):
        for (names, sizes, shape, spec), want in zip(SHARD_CASES, runs["ref"]["shard_specs"],
                                                     strict=True):
            mesh = init_device_mesh("cpu", sizes, mesh_dim_names=names)
            want = rules.PartitionSpec(*[tuple(e) if isinstance(e, list) else e for e in want])
            got = shard(meta_dtensor(shape, mesh), *spec)
            assert tuple(got.placements) == rules.placements(want, mesh), (names, shape, spec)
            assert rules.clean_spec(spec, shape, mesh) == want + (None,) * (
                len(shape) - len(want))


def test_opcost_counts_one_sharded_linear_by_hand():
    """x (8, 16) batch over ``data`` @ w (16, 32) FSDP over ``data`` and TP
    over ``model`` on a fake (4, 2) group: one device does 2·2·16·16
    FLOPs after all-gathering its (4, 16) shard of w over the 4 ranks of
    ``data`` (256 operand bytes, 3 x 256 on the wire); DTensor's sharding
    propagation at the global shape is not counted, nor its allocations.
    A 3-D input (DTensor propagates its matmul through a decomposition on
    ``meta`` tensors) counts its local product once; a head shard moved to
    a sequence shard counts one all-to-all."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    with fake_group(8):
        # device type cuda, as the dry run's meshes: DTensor then picks the
        # collectives NCCL runs (gloo's has no all-to-all); no device is touched
        mesh = init_device_mesh("cuda", (4, 2), mesh_dim_names=("data", "model"))
        x = meta_dtensor((8, 16), mesh, (Shard(0), Replicate()))
        w = meta_dtensor((16, 32), mesh, (Shard(0), Shard(1)))
        for _ in range(2):  # the first call propagates on FakeTensors, the second hits the cache
            with OpCost(live=(x, w)) as cost:
                y = x @ w
            assert tuple(y.placements) == (Shard(0), Shard(1))
            assert cost.flops == 2 * 2 * 16 * 16
            assert cost.bytes == (2 * 16 + 16 * 16 + 2 * 16) * 4  # local mm in and out
            assert cost.by_op()["flops"] == [["mm", 1024]]
            coll = cost.collectives
            assert coll["all-gather"] == {"count": 1, "operand_bytes": 256, "wire_bytes": 768}
            assert coll["total_operand_bytes"] == 256 and coll["total_wire_bytes"] == 768
            assert all(coll[op]["count"] == 0 for op in COLL_OPS if op != "all-gather")
            assert cost.live_bytes == 2 * 512  # the local shards, in allocator blocks
            assert cost.peak_bytes == 2 * 512 + 1024 + 512  # + gathered w and y
        # (3, 8, 16) @ w: a matmul DTensor propagates through its decomposition
        # on meta tensors at the global shape the first time; counted once, locally
        x3 = meta_dtensor((3, 8, 16), mesh, (Replicate(), Replicate()))
        with OpCost(live=(x3, w)) as cost:
            y = x3 @ w
        k = 16 // 4 if y.placements[0].is_partial() else 16  # D split over data, or not
        assert y.placements[1] == Shard(2)
        assert cost.flops == 2 * y.to_local().numel() * k == cost.by_op()["flops"][0][1]
        # q's heads to its sequence over model (attention_train's shard): one
        # all-to-all of the (2, 16, 2, 8) float32 shard, (n-1)/n of it on the wire
        q = meta_dtensor((8, 16, 4, 8), mesh, (Shard(0), Shard(2)))
        with OpCost(live=(q,)) as cost:
            q = shard(q, ("pod", "data"), "model", None, None)
        assert tuple(q.placements) == (Shard(0), Shard(1)) and cost.bytes == cost.flops == 0
        assert cost.collectives["all-to-all"] == {"count": 1, "operand_bytes": 2048,
                                                  "wire_bytes": 1024}


def test_opcost_leaves_out_the_sharding_propagation_of_a_decomposed_matmul():
    """Under ``inference_mode`` DTensor propagates a 3-D ``matmul`` through
    its decomposition, on ``meta`` tensors at the global shape (3,584
    bytes here) and on a one-device mesh of CPU tensors: none of it is
    this device's.  x (5, 8, 16) replicated @ w (16, 32) FSDP/TP on a fake
    (4, 2) group: x's (5, 8, 4) slice is copied (640 bytes, two 512-byte
    blocks), the local product (40, 4) @ (4, 16) gives y's (5, 8, 16)
    shard, partial over ``data`` (2,560 bytes, 5 blocks); the peak is the
    arguments (2,560 + 512) plus those two, and nothing else is live."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Partial, Replicate, Shard

    with fake_group(8):
        mesh = init_device_mesh("cuda", (4, 2), mesh_dim_names=("data", "model"))
        x = meta_dtensor((5, 8, 16), mesh, (Replicate(), Replicate()))
        w = meta_dtensor((16, 32), mesh, (Shard(0), Shard(1)))
        with torch.inference_mode(), OpCost(live=(x, w)) as cost:
            y = x @ w
        assert tuple(y.placements) == (Partial(), Shard(2))
        assert cost.flops == 2 * 5 * 8 * 4 * 16
        assert dict(cost.peak_by_op) == {"arguments": 2560 + 512, "clone": 1024, "mm": 2560}
        assert cost.peak_bytes == 2560 + 512 + 1024 + 2560
        assert cost.collectives["total_operand_bytes"] == 0


GET_CONFIG = registry.get_config


def smoke_llama(arch, smoke=False):
    """The smoke llama with head dim 64 (``meta`` runs #8's card checks)."""
    return dataclasses.replace(GET_CONFIG(arch, smoke=True), head_dim=64)


CELLS = [(mesh, "smoke", shape, batch, seq) for mesh in ("single", "multi")
         for shape, batch, seq in (("train_4k", 32, 256), ("prefill_32k", 16, 256),
                                   ("decode_32k", 64, 512))]
CELLS += [(mesh, "llama32_1b", shape, batch, seq) for mesh in ("single", "multi")
          for shape, batch, seq in (("prefill_32k", 32, 2048), ("decode_32k", 64, 4096))]
# llama3.2-1B's train step on 2x16x16 takes minutes of DTensor's planning
# (nested pod x data shards), so only the 16x16 one runs here
CELLS += [("single", "llama32_1b", "train_4k", 32, 2048)]


@pytest.mark.parametrize("mesh_name,arch,shape,batch,seq", CELLS)
def test_dry_run_on_the_production_meshes(monkeypatch, tmp_path, mesh_name, arch, shape,
                                          batch, seq):
    """The cell's step sharded on a fake group of 256 / 512 ranks on
    ``meta`` (the smoke llama at head dim 64, and llama3.2-1B, at cut
    shapes): cost, peak and collectives filled in with the reference's
    keys, argument bytes of the placed shards equal to the rules'
    ``sharded_memory``, per-device FLOPs x devices at least the card's."""
    if arch == "smoke":
        monkeypatch.setattr(registry, "get_config", smoke_llama)
    rec = dryrun.run_cell("llama32_1b", shape, mesh_name, tmp_path, force=True,
                          global_batch=batch, seq_len=seq)
    card = dryrun.run_cell("llama32_1b", shape, "card", tmp_path, force=True,
                           global_batch=batch, seq_len=seq)
    assert rec["n_devices"] == {"single": 256, "multi": 512}[mesh_name]
    assert "note" not in rec
    cost, coll, mem = rec["cost"], rec["collectives"], rec["memory"]
    assert cost["flops_per_device"] > 0 and cost["bytes_accessed_per_device"] > 0
    assert set(coll) == set(COLL_OPS) | {"total_operand_bytes", "total_wire_bytes"}
    assert coll["total_wire_bytes"] == sum(coll[op]["wire_bytes"] for op in COLL_OPS) > 0
    cfg = registry.get_config("llama32_1b")
    want = dryrun.sharded_memory(cfg, shape, dryrun.make_mesh(mesh_name), batch, seq)
    scalar = 0 if shape == "prefill_32k" else 4  # the int32 AdamW step / decode position
    assert mem["argument_bytes_per_device"] == want["argument_bytes_per_device"] + scalar
    assert mem["peak_bytes_per_device"] >= mem["argument_bytes_per_device"]
    assert cost["flops_per_device"] * rec["n_devices"] >= card["cost"]["flops_per_device"]


@pytest.mark.parametrize("arch", registry.ARCHS)
def test_paths_that_do_not_run_sharded_refuse_dtensors(arch):
    """Each arch's smoke prefill on DTensors over a fake (2, 2) group on
    ``meta``: the dense attention path (``transformer.runs_sharded``: every
    mixer ``attn``, no MoE FFN, no frontend) runs and gives the (B, 1, V)
    logits; any other mixer, the MoE FFN or a frontend raises
    ``NotImplementedError`` naming ROADMAP A4d."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(registry.get_config(arch, smoke=True), head_dim=64)
    dense = (set(cfg.block_pattern + cfg.tail_pattern) == {"attn"} and cfg.ffn_kind != "moe"
             and cfg.frontend == "none")
    assert T.runs_sharded(cfg) == dense
    with fake_group(4):
        mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
        args = dryrun.place_args(dryrun.cell_args(cfg, "prefill_32k", 4, 128), "prefill", mesh)
        step = dryrun.step_fn(cfg, "prefill_32k")
        with torch.inference_mode():
            if dense:
                out = step(*args)
                assert isinstance(out, DTensor) and out.shape == (4, 1, cfg.padded_vocab)
            else:
                with pytest.raises(NotImplementedError, match="A4d"):
                    step(*args)


def test_dry_run_keeps_argument_bytes_where_the_step_does_not_run_sharded(tmp_path):
    """The mqr-KV sparse decode and the other families keep the rules'
    argument bytes, with a note naming ROADMAP A4d and nothing counted."""
    rec = dryrun.run_cell("llama32_1b", "long_500k", "single", tmp_path, force=True)
    assert rec["cost"] is None and rec["collectives"] is None and "A4d" in rec["note"]
    rec = dryrun.run_cell("mamba2_2p7b", "train_4k", "multi", tmp_path, force=True)
    assert rec["cost"] is None and rec["memory"]["argument_bytes_per_device"] > 0
