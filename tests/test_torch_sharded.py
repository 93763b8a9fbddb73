"""The sharded step (DTensor over a ``DeviceMesh``) held to the JAX package's
sharded step on the CPU.

- **Train, prefill, decode.**  The smoke llama (float32) on four gloo ranks
  over a (2, 2) ``("data", "model")`` mesh (``launch.steps.place`` with the
  rules' placements) against the reference jitted with ``in_shardings``
  on a (2, 2) mesh of four forced host devices, both in subprocesses
  started together, from the same parameters (the reference's
  ``init_params``, carried across by ``convert``) and the same batches: three
  ``make_train_step`` steps with remat off, ``"full"`` and ``"dots"`` (loss,
  grad_norm, lr and every final parameter within 1e-4, relative and
  absolute, as ``test_torch_train``'s five unsharded steps), the prefill
  logits (1e-4) and six greedy decode tokens (equal); the same ranks as a
  (1, 4) mesh (one query head a rank, the decode caches' sequence sharded)
  for the train step and the decode tokens.
- **The other families** (``FAMILIES``): the smoke granite-moe (both MoE
  dispatches) and DeepSeek (MLA, a dense stack and the MoE), gemma-2b,
  granite-8b and command-r-35b in the same two runs; mamba2-2.7b (SSD on
  head shards, two chunks), recurrentgemma-9b (RG-LRU on width shards,
  the local ring of 8 slots on slot shards, wrapped by the decode),
  internvl2-2b (patch embeddings beside the vocab-parallel lookup) and
  musicgen-large (two codebooks on vocab shards) in a second pair of runs
  (``LAST_FOUR``): three train steps (remat "full"; ``expert_load_max``
  equal), prefill and the greedy decode tokens on the (2, 2) mesh, and
  for the MoE, Mamba-2 and RG-LRU families the train step and the tokens
  on the (1, 4) mesh (one expert, two heads or 16 of the width a rank;
  DeepSeek's latent cache and the ring sequence-sharded four ways).
- **``modules.shard``** on a DTensor gives the placements of the
  reference's cleaned spec (the output sharding of ``jax.jit(lambda x:
  shard(x, *spec))`` under the reference's mesh) on a (4, 2) and a
  (2, 2, 2) mesh, and is the identity on a plain tensor; the MoE FFN
  constrains its xe and ye as the reference does.
- **``OpCost`` under DTensor**, counted by hand on one FSDP/TP linear,
  with DTensor's sharding propagation left out of the peak.
- **Every arch's prefill runs sharded** on a fake group; the mqr-KV sparse
  decode, the one path that does not yet, raises ``NotImplementedError``
  on DTensors.
- **The dry run on the production meshes** (fake process groups of 256
  and 512 ranks, ``meta`` shards): non-null per-device cost, peak and
  collectives with the reference's keys, argument bytes equal to the
  rules' ``shard_shape``, and per-device FLOPs x devices no less than one
  card's; llama, granite-moe and DeepSeek, and the last four families on
  the 16x16 mesh.

Each of the two pairs of runs is made once a test session (under xdist,
once for all workers: a file lock of its own in the session's temporary
root, so two workers can make the two pairs at once).
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
from repro.data.pipeline import DataConfig, SyntheticLM
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
TRAIN_BATCH = 2
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=5)
# the other families held to the reference's sharded step on the (2, 2) mesh:
# arch -> its train runs (name: overrides, remat "full"), whether the (1, 4)
# mesh runs its train step (the first run's) and decode tokens too, and the
# overrides of its smoke config for every run ("cfg"): the smoke Mamba-2's
# chunk of 32 would leave S 16 one chunk (8: the state carried across two),
# the smoke recurrentgemma's window of 32 a ring that never wraps (8, with
# 12 decode steps)
FAMILIES = {
    "granite_moe_1b": dict(train={"full": REMATS["full"],
                                  "scatter": dict(REMATS["full"], moe_dispatch="scatter")},
                           mesh_1x4=True),
    "deepseek_v3_671b": dict(train={"full": REMATS["full"]}, mesh_1x4=True),
    "gemma_2b": dict(train={"full": REMATS["full"]}, mesh_1x4=False),
    "granite_8b": dict(train={"full": REMATS["full"]}, mesh_1x4=False),
    "command_r_35b": dict(train={"full": REMATS["full"]}, mesh_1x4=False),
    "mamba2_2p7b": dict(train={"full": REMATS["full"]}, mesh_1x4=True,
                        cfg=dict(ssd_chunk=8)),
    "recurrentgemma_9b": dict(train={"full": REMATS["full"]}, mesh_1x4=True,
                              cfg=dict(local_window=8), decode_steps=12),
    "internvl2_2b": dict(train={"full": REMATS["full"]}, mesh_1x4=False),
    "musicgen_large": dict(train={"full": REMATS["full"]}, mesh_1x4=False),
}
# the families of the second pair of runs
LAST_FOUR = ("mamba2_2p7b", "recurrentgemma_9b", "internvl2_2b", "musicgen_large")
# AdamW of the families' runs: OPT with an eps above the float32 noise of a
# gradient that cancels to ~1e-6 of its leaf's RMS (gemma-2b's first
# gradient at blocks/0/l0/ffn/w_out[86, 34] is -1.36e-8, leaf RMS 9.9e-3):
# at eps 1e-8 the first update there is lr x g / (|g| + eps), and the
# rounding of g alone moves it by ~3e-4 (the unsharded port already differs
# from the reference by 2.7e-4 at command-r-35b's blocks/1/l0/mixer/wo[36,
# 20]); at 1e-6 by < 2e-5
FAMILY_OPT = dict(OPT, eps=1e-6)
# xe / ye of the smoke MoE FFN on (B, S) = (4, 16) and (3, 16): (B, E, C, D),
# C = 16 * 2 / 4 * 4.0 (a B of 3 does not divide over the data axis)
MOE_SHAPES = [(4, 4, 32, 64), (3, 4, 32, 64)]
FAMILY_TRAINS = [(arch, name) for arch, spec in FAMILIES.items() for name in spec["train"]]
MOE_ARCHS = ["granite_moe_1b", "deepseek_v3_671b"]
RECURRENT_ARCHS = ["mamba2_2p7b", "recurrentgemma_9b"]
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
    return family_cfgs("llama32_1b", **over)


def family_cfgs(arch, **over):
    """The reference's and the port's smoke configs of ``arch`` in float32."""
    over = dict(dtype="float32", **over)
    return (dataclasses.replace(ref_registry.get_config(arch, smoke=True), **over),
            dataclasses.replace(registry.get_config(arch, smoke=True), **over))


REF = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import registry
from repro.launch import steps
from repro.models import transformer as T
from repro.models.modules import shard
from repro.optim import adamw
from repro.sharding import rules
d = pickle.load(open(sys.argv[1], "rb"))
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
tree = lambda t: jax.tree.map(np.asarray, t)
jnp_tree = lambda t: jax.tree.map(jnp.asarray, t)


def config(arch, fam, **over):
    base = registry.get_config(arch, smoke=True)
    return dataclasses.replace(base, dtype="float32", **fam["cfg"], **over)


def train(cfg, fam):
    ocfg = adamw.AdamWConfig(**fam["opt"])
    params = jnp_tree(fam["params"])
    state = adamw.init_state(params, ocfg)
    psh = rules.param_shardings(params, mesh)
    osh = adamw.AdamWState(step=NamedSharding(mesh, P()), m=psh, v=psh)
    bsh = rules.batch_shardings(jnp_tree(fam["batches"][0]), mesh)
    step = jax.jit(steps.make_train_step(cfg, ocfg), in_shardings=(psh, osh, bsh))
    metrics = []
    for b in fam["batches"]:
        # XLA may return a leaf on other shardings than in_shardings (Mamba-2's
        # replicated (layers, heads) A_log with its heads over model): back
        # to the rules' before the next step, the values unchanged
        params, state = jax.device_put((params, state), (psh, osh))
        params, state, m = step(params, state, jnp_tree(b))
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr", "expert_load_max")})
    return {"metrics": metrics, "params": tree(params)}


def prefill(cfg, fam):
    params = jnp_tree(fam["params"])
    batch = jnp_tree(fam["prompt"])
    pre = jax.jit(steps.make_prefill_step(cfg), in_shardings=(
        rules.param_shardings(params, mesh), rules.batch_shardings(batch, mesh)))
    return np.asarray(pre(params, batch))


def decode(cfg, fam):
    params = jnp_tree(fam["params"])
    prompt = fam["prompt"]["tokens"]
    caches = T.init_caches(cfg, prompt.shape[0], d["max_len"])
    tok = jnp.asarray(prompt[:, :1])
    tsh = NamedSharding(mesh, rules.batch_spec(tok.shape, mesh))
    csh = rules.cache_shardings(caches, mesh)
    serve = jax.jit(steps.make_serve_step(cfg), in_shardings=(
        rules.param_shardings(params, mesh), tsh, csh, NamedSharding(mesh, P())))
    toks = []
    for i in range(fam["decode_steps"]):
        # as in train: the returned caches back on the rules' shardings (the
        # local ring's replicated slot positions come back over model)
        tok, caches = jax.device_put((tok, caches), (tsh, csh))
        tok, caches = serve(params, tok, caches, jnp.asarray(i, jnp.int32))
        toks.append(np.asarray(tok))
    return np.stack(toks)


out = {"families": {}}
with mesh:
    if "llama" in d:
        fam = d["llama"]
        base = config("llama32_1b", fam)
        out["train"] = {name: train(config("llama32_1b", fam, **over), fam)
                        for name, over in fam["train"].items()}
        out["prefill"] = prefill(base, fam)
        out["decode"] = decode(base, fam)
    for arch, fam in d["families"].items():
        got = out["families"][arch] = {}
        got["train"] = {name: train(config(arch, fam, **over), fam)
                        for name, over in fam["train"].items()}
        got["prefill"] = prefill(config(arch, fam), fam)
        got["decode"] = decode(config(arch, fam), fam)
if "shard_cases" in d:
    specs = []
    for names, sizes, shape, spec in d["shard_cases"]:
        m = Mesh(np.array(jax.devices()[:int(np.prod(sizes))]).reshape(sizes), names)
        with m:
            y = jax.jit(lambda x: shard(x, *spec))(jnp.zeros(shape, jnp.float32))
        specs.append([list(e) if isinstance(e, tuple) else e for e in y.sharding.spec])
    out["shard_specs"] = specs
    specs = []
    for shape in d["moe_shapes"]:
        y = jax.jit(lambda x: shard(x, ("pod", "data"), "model", None, None))
        with mesh:
            specs.append([list(e) if isinstance(e, tuple) else e
                          for e in y(jnp.zeros(shape, jnp.float32)).sharding.spec])
    out["moe_specs"] = specs
pickle.dump(out, open(sys.argv[2], "wb"))
"""

PORT = """
import dataclasses, pickle, sys
import numpy as np
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import steps
from repro_torch.models import transformer as T
from repro_torch.models.modules import tree_leaves
from repro_torch.optim import AdamWConfig
from repro_torch.sharding import rules
rank = int(sys.argv[3])
dist.init_process_group("gloo", init_method=f"file://{sys.argv[4]}", rank=rank, world_size=4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
# a (1, 4) mesh: one query head a rank and the two kv heads replicated (GQA by
# global head index), the decode caches' sequence over model (flash-decoding)
mesh4 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
d = pickle.load(open(sys.argv[1], "rb"))
full = lambda t: t.full_tensor().detach().numpy()
torch_tree = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}


def config(arch, fam, **over):
    base = registry.get_config(arch, smoke=True)
    return dataclasses.replace(base, dtype="float32", **fam["cfg"], **over)


def on(tree, m, shardings):
    return steps.place(tree, shardings(tree, m), m)


def placed(cfg, fam, m):
    return on(convert.params_from_numpy(fam["params"], cfg, device="cpu"), m,
              rules.param_shardings)


def train_run(cfg, fam, m):
    params = convert.params_from_numpy(fam["params"], cfg, device="cpu")
    state = steps.place_opt_state(convert.opt_state_from_numpy(fam["opt_state"], cfg,
                                                               device="cpu"), params, m)
    params = on(params, m, rules.param_shardings)
    step = steps.make_train_step(cfg, AdamWConfig(**fam["opt"]))
    metrics = []
    for b in fam["batches"]:
        params, state, met = step(params, state, on(torch_tree(b), m, rules.batch_shardings))
        metrics.append({k: float(met[k].full_tensor())
                        for k in ("loss", "grad_norm", "lr", "expert_load_max")})
    return {"metrics": metrics, "params": [full(p) for p in tree_leaves(params)],
            "types": sorted({type(p).__name__ for p in tree_leaves(params) + [
                met["expert_load_max"]]})}


def prefill_run(cfg, fam, m):
    with torch.inference_mode():
        return full(steps.make_prefill_step(cfg)(placed(cfg, fam, m), on(
            torch_tree(fam["prompt"]), m, rules.batch_shardings)))


def decode_run(cfg, fam, m):
    params = placed(cfg, fam, m)
    prompt = fam["prompt"]["tokens"]
    caches = on(T.init_caches(cfg, prompt.shape[0], d["max_len"], device="cpu"), m,
                rules.cache_shardings)
    tok = on({"t": torch.from_numpy(prompt[:, :1])}, m, rules.batch_shardings)["t"]
    serve = steps.make_serve_step(cfg)
    toks = []
    with torch.inference_mode():
        for i in range(fam["decode_steps"]):
            tok, caches = serve(params, tok, caches, torch.tensor(i, dtype=torch.int32))
            toks.append(full(tok))
    return np.stack(toks), caches


def placements(tree):
    return sorted({(path.split("/")[-1], str(c.placements))
                   for path, c in rules.leaves_with_path(tree)})


def expert_placements(params):
    return sorted({(path.split("/")[-1], str(p.placements))
                   for path, p in rules.leaves_with_path(params)
                   if path.split("/")[-1] in ("w_in", "w_gate", "w_out") and p.dim() == 3})


out = {"families": {}}
if "llama" in d:
    fam = d["llama"]
    base = config("llama32_1b", fam)
    out["train"] = {name: train_run(config("llama32_1b", fam, **over), fam, mesh)
                    for name, over in fam["train"].items()}
    out["prefill"] = prefill_run(base, fam, mesh)
    out["decode"], caches = decode_run(base, fam, mesh)
    out["cache_placements"] = sorted({str(c.placements) for c in tree_leaves(caches)})
    out["cache_types"] = sorted({type(c).__name__ for c in tree_leaves(caches)})
    out["train_1x4"] = train_run(base, fam, mesh4)
    out["decode_1x4"], caches = decode_run(base, fam, mesh4)
    out["cache_placements_1x4"] = sorted({str(c.placements) for c in tree_leaves(caches)})
for arch, fam in d["families"].items():
    got = out["families"][arch] = {}
    base = config(arch, fam)
    got["train"] = {name: train_run(config(arch, fam, **over), fam, mesh)
                    for name, over in fam["train"].items()}
    got["experts"] = expert_placements(placed(base, fam, mesh))
    got["prefill"] = prefill_run(base, fam, mesh)
    got["decode"], caches = decode_run(base, fam, mesh)
    got["cache_placements"] = placements(caches)
    got["ring"] = [full(c) for path, c in rules.leaves_with_path(caches) if path.endswith("/pos")]
    if fam["mesh_1x4"]:
        over = next(iter(fam["train"].values()))
        got["train_1x4"] = train_run(config(arch, fam, **over), fam, mesh4)
        got["experts_1x4"] = expert_placements(placed(base, fam, mesh4))
        got["decode_1x4"], caches = decode_run(base, fam, mesh4)
        got["cache_placements_1x4"] = placements(caches)
if "llama" in d:
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
RUN_TIMEOUT = 600


def _ref_state(ref_cfg) -> tuple:
    """The reference's parameters (seed 3) and AdamW state of ``ref_cfg``,
    as numpy trees."""
    params = jax.jit(lambda key: ref_T.init_params(key, ref_cfg))(jax.random.PRNGKey(3))
    state = ref_adamw.init_state(params, ref_adamw.AdamWConfig(**OPT))
    tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return tree(params), tuple(tree(s) for s in state)


def _batches(cfg, seed: int) -> list:
    """``STEPS`` training batches of (``TRAIN_BATCH``, ``SEQ``) positions:
    ``SyntheticLM``'s for token models (the reference's pipeline, which the
    port's equals bit for bit); for the frontends drawn from ``seed``,
    codebook ids (B, S, K) with their next ids as labels, or a vision
    model's patch embeddings with the text tokens that fill S."""
    if cfg.frontend == "none":
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                      global_batch=TRAIN_BATCH))
        return [data.batch(i) for i in range(STEPS)]
    return [_frontend_batch(cfg, TRAIN_BATCH, seed + i) for i in range(STEPS)]


def _frontend_batch(cfg, b: int, seed: int, labels: bool = True) -> dict:
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_codebooks":
        toks = rng.integers(0, cfg.vocab_size, (b, SEQ + 1, cfg.n_codebooks), dtype=np.int32)
    else:
        toks = rng.integers(0, cfg.vocab_size, (b, SEQ - cfg.n_patches + 1), dtype=np.int32)
    out = {"tokens": toks[:, :-1]}
    if labels:
        out["labels"] = toks[:, 1:]
    if cfg.frontend == "vision_patches":
        out["vision_embeds"] = rng.standard_normal((b, cfg.n_patches, cfg.d_model),
                                                   dtype=np.float32)
    return out


def _family_inputs(arch, spec, opt) -> dict:
    """What both subprocesses start from for ``arch``: the reference's smoke
    parameters and AdamW state (numpy), the training batches, the prompt
    (B ``BATCH`` x S ``SEQ``) and the run's settings."""
    spec = dict(spec, cfg=spec.get("cfg", {}), decode_steps=spec.get("decode_steps",
                                                                     DECODE_STEPS))
    ref_cfg = family_cfgs(arch, **spec["cfg"])[0]
    params, state = _ref_state(ref_cfg)
    if ref_cfg.frontend == "none":
        prompt = {"tokens": np.random.default_rng(5).integers(
            0, ref_cfg.vocab_size, (BATCH, SEQ), dtype=np.int32)}
    else:
        prompt = _frontend_batch(ref_cfg, BATCH, 5, labels=False)
    return dict(spec, params=params, opt_state=state, opt=opt,
                batches=_batches(ref_cfg, 7), prompt=prompt)


def _inputs(archs, llama: bool) -> dict:
    """The inputs of one pair of runs: the families ``archs`` (and llama,
    with the ``shard`` and MoE spec cases, where ``llama``)."""
    out = {"max_len": MAX_LEN,
           "families": {a: _family_inputs(a, FAMILIES[a], FAMILY_OPT) for a in archs}}
    if llama:
        out["llama"] = _family_inputs("llama32_1b", dict(train=REMATS), OPT)
        out.update(shard_cases=SHARD_CASES, moe_shapes=MOE_SHAPES)
    return out


def _run_both(root: pathlib.Path, inputs_of) -> dict:
    """The reference's run and the port's four ranks, started together on
    ``inputs_of()``; the
    ranks meet through a file store (no port to race for).  Each process
    writes its output to a file of its own; when one fails, or the run
    outlasts ``RUN_TIMEOUT``, the others are killed and every process's
    stderr is shown."""
    inputs, ref_out, port_out = root / "in.pkl", root / "ref.pkl", root / "port.pkl"
    inputs.write_bytes(pickle.dumps(inputs_of()))
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


def _shared_runs(tmp_path_factory, name: str, inputs_of) -> dict:
    """A pair of sharded runs, made once a session: under xdist every
    worker's temporary root shares a parent, and a lock there (one a pair,
    in the folder ``name``) lets one worker make them while the others wait
    and read its results, or its failure."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    root = root / name
    root.mkdir(exist_ok=True)
    done, failed = root / "runs.pkl", root / "failed.txt"
    with open(root / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if failed.exists():
            pytest.fail(f"the sharded runs failed in another worker:\n{failed.read_text()}")
        if not done.exists():
            try:
                done.write_bytes(pickle.dumps(_run_both(root, inputs_of)))
            except BaseException as e:
                failed.write_text(f"{type(e).__name__}: {e}")
                raise
    return pickle.loads(done.read_bytes())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """llama and the families before ``LAST_FOUR``, sharded on both sides."""
    first = [a for a in FAMILIES if a not in LAST_FOUR]
    return _shared_runs(tmp_path_factory, "torch_sharded", lambda: _inputs(first, llama=True))


@pytest.fixture(scope="module")
def last_runs(tmp_path_factory):
    """The families of ``LAST_FOUR``, sharded on both sides: a pair of runs
    of its own, which another xdist worker can make beside the first."""
    return _shared_runs(tmp_path_factory, "torch_sharded_last",
                        lambda: _inputs(LAST_FOUR, llama=False))


def family_runs(request, arch) -> dict:
    """The pair of runs that holds ``arch``."""
    return request.getfixturevalue("last_runs" if arch in LAST_FOUR else "runs")


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


def _check_family_train(ref, port, arch, over):
    """Metrics each step within 1e-4 (the expert load's max equal), every
    final parameter within 1e-4, every parameter and the load DTensors."""
    assert port["types"] == ["DTensor"]
    for want, got in zip(ref["metrics"], port["metrics"], strict=True):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[key], want[key], rtol=TOL, err_msg=key)
        assert got["expert_load_max"] == want["expert_load_max"]
    _, cfg = family_cfgs(arch, **FAMILIES[arch].get("cfg", {}), **over)
    for got, want in zip(port["params"], ref_leaves(ref["params"], cfg), strict=True):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch,name", FAMILY_TRAINS)
def test_sharded_family_train_step_matches_the_reference(request, arch, name):
    """Three ``make_train_step`` steps (remat "full") of the smoke MoE and
    MLA families (granite-moe in both dispatches; DeepSeek with its dense
    stack and MTP), of the dense-path gemma-2b, granite-8b and
    command-r-35b, of Mamba-2 (two SSD chunks), recurrentgemma (its local
    window of 8 two bands of the 16 tokens) and of the two frontends on the
    (2, 2) mesh equal the reference's sharded steps (AdamW with
    ``FAMILY_OPT``): loss, grad_norm and lr within 1e-4, ``expert_load_max``
    equal (the ranks' whole-number counts summed before the mean), every
    final parameter within 1e-4."""
    got = family_runs(request, arch)
    ref = got["ref"]["families"][arch]["train"][name]
    port = got["port"]["families"][arch]["train"][name]
    _check_family_train(ref, port, arch, FAMILIES[arch]["train"][name])


def logits_shape(arch) -> tuple:
    """The prefill's last logits (B, 1, V), (B, 1, K, V) for audio."""
    cfg = registry.get_config(arch, smoke=True)
    k = (cfg.n_codebooks,) if cfg.frontend == "audio_codebooks" else ()
    return (BATCH, 1, *k, cfg.padded_vocab)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_sharded_family_prefill_matches_the_reference(request, arch):
    """The last logits of a prompt of ``SEQ`` positions (internvl2's
    patches and text, musicgen's two codebooks a position) within 1e-4."""
    got = family_runs(request, arch)
    got, want = got["port"]["families"][arch]["prefill"], got["ref"]["families"][arch]["prefill"]
    assert got.shape == want.shape == logits_shape(arch)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_sharded_family_decode_tokens_equal_the_reference(request, arch):
    """Six greedy steps on the (2, 2) mesh (twelve for recurrentgemma, whose
    ring of 8 slots wraps), the caches placed by ``cache_shardings`` and
    written on each rank's shard: DeepSeek's latent and recurrentgemma's
    ring with their sequence over ``model`` (the flash-decoding combine),
    Mamba-2's conv window on channel and its state on head shards,
    the RG-LRU's window and state on width shards; musicgen's tokens (B,
    1, K)."""
    got = family_runs(request, arch)
    port, ref = got["port"]["families"][arch], got["ref"]["families"][arch]
    np.testing.assert_array_equal(port["decode"], ref["decode"])
    steps_run = FAMILIES[arch].get("decode_steps", DECODE_STEPS)
    k = logits_shape(arch)[2:-1]
    assert port["decode"].shape == (steps_run, BATCH, 1, *k)
    want = {"deepseek_v3_671b": [("c_kv", "(Shard(dim=0), Shard(dim=1))")],
            "mamba2_2p7b": [("conv", "(Shard(dim=0), Shard(dim=2))"),
                            ("ssm", "(Shard(dim=0), Shard(dim=1))")],
            "recurrentgemma_9b": [("k", "(Shard(dim=0), Shard(dim=2))"),
                                  ("conv", "(Shard(dim=0), Shard(dim=2))"),
                                  ("h", "(Shard(dim=0), Shard(dim=1))")]}.get(arch, [])
    assert set(want) <= set(port["cache_placements"]), port["cache_placements"]
    if arch == "recurrentgemma_9b":
        window = FAMILIES[arch]["cfg"]["local_window"]
        for ring in port["ring"]:  # each local layer's slots hold the last 8 positions
            assert sorted(ring.tolist()) == list(range(steps_run - window, steps_run))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_sharded_family_step_on_a_1x4_mesh_matches_the_reference(runs, arch):
    """The four ranks as a (1, 4) mesh: one expert a rank (w_in / w_gate
    (E, D, F) and w_out (E, F, D) shard E over ``model``), DeepSeek's
    latent cache sequence-sharded four ways; three train steps within 1e-4
    of the reference's (2, 2) run and the six decode tokens equal."""
    ref, port = runs["ref"]["families"][arch], runs["port"]["families"][arch]
    name = next(iter(FAMILIES[arch]["train"]))
    _check_family_train(ref["train"][name], port["train_1x4"], arch, FAMILIES[arch]["train"][name])
    assert {pl for _, pl in port["experts_1x4"]} == {"(Shard(dim=1), Shard(dim=0))",
                                                     "(Shard(dim=2), Shard(dim=0))"}
    assert {pl for _, pl in port["experts"]} == {"(Shard(dim=1), Shard(dim=0))",
                                                 "(Shard(dim=2), Shard(dim=0))"}
    if arch == "deepseek_v3_671b":
        assert ("c_kv", "(Shard(dim=0), Shard(dim=1))") in port["cache_placements_1x4"]
    np.testing.assert_array_equal(port["decode_1x4"], ref["decode"])


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_sharded_recurrent_family_step_on_a_1x4_mesh_matches_the_reference(last_runs, arch):
    """The four ranks as a (1, 4) mesh: Mamba-2's 8 heads two a rank (its
    projection's 296 columns 74 a rank, the edges of z, x, B, C and dt
    inside them), recurrentgemma's width of 64 16 a rank and its ring of 8
    slots two a rank, its one kv head replicated under one query head a
    rank; three train steps within 1e-4 of the reference's (2, 2) run and
    the decode tokens equal."""
    ref, port = last_runs["ref"]["families"][arch], last_runs["port"]["families"][arch]
    name = next(iter(FAMILIES[arch]["train"]))
    _check_family_train(ref["train"][name], port["train_1x4"], arch, FAMILIES[arch]["train"][name])
    want = {"mamba2_2p7b": [("conv", "(Shard(dim=0), Shard(dim=2))"),
                            ("ssm", "(Shard(dim=0), Shard(dim=1))")],
            "recurrentgemma_9b": [("k", "(Shard(dim=0), Shard(dim=2))"),
                                  ("h", "(Shard(dim=0), Shard(dim=1))")]}[arch]
    assert set(want) <= set(port["cache_placements_1x4"]), port["cache_placements_1x4"]
    np.testing.assert_array_equal(port["decode_1x4"], ref["decode"])


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


# the smoke granite-moe and DeepSeek (head dim 64) at the same cut shapes
FAMILY_CELLS = [(mesh, arch, shape, batch, seq) for mesh in ("single", "multi")
                for arch in MOE_ARCHS
                for shape, batch, seq in (("train_4k", 32, 256), ("prefill_32k", 16, 256),
                                          ("decode_32k", 64, 512))]
# the last four smoke families (head dim 64) at the same cut shapes, on 16x16
LAST_FAMILY_CELLS = [("single", arch, shape, batch, seq) for arch in LAST_FOUR
                     for shape, batch, seq in (("train_4k", 32, 256), ("prefill_32k", 16, 256),
                                               ("decode_32k", 64, 512))]


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
    _check_cell(tmp_path, "llama32_1b", mesh_name, shape, batch, seq)


@pytest.mark.parametrize("mesh_name,arch,shape,batch,seq", FAMILY_CELLS)
def test_dry_run_of_the_moe_and_mla_families_on_the_production_meshes(
        monkeypatch, tmp_path, mesh_name, arch, shape, batch, seq):
    """As llama's cells, for the smoke granite-moe (experts over ``model``)
    and the smoke DeepSeek (MLA, its dense stack and the MoE): the step
    runs sharded, with every invariant of llama's cells."""
    monkeypatch.setattr(registry, "get_config", smoke_llama)
    _check_cell(tmp_path, arch, mesh_name, shape, batch, seq)


@pytest.mark.parametrize("mesh_name,arch,shape,batch,seq", LAST_FAMILY_CELLS)
def test_dry_run_of_the_last_four_families_on_the_production_mesh(
        monkeypatch, tmp_path, mesh_name, arch, shape, batch, seq):
    """As llama's cells, for the smoke mamba2 (heads over ``model`` where
    they divide), recurrentgemma (the width over ``model``, the ring's
    slots), internvl2 (patch embeddings) and musicgen (codebooks on vocab
    shards) on the 16x16 mesh: the step runs sharded, with every invariant
    of llama's cells."""
    monkeypatch.setattr(registry, "get_config", smoke_llama)
    _check_cell(tmp_path, arch, mesh_name, shape, batch, seq)


def _check_cell(tmp_path, arch, mesh_name, shape, batch, seq):
    rec = dryrun.run_cell(arch, shape, mesh_name, tmp_path, force=True,
                          global_batch=batch, seq_len=seq)
    card = dryrun.run_cell(arch, shape, "card", tmp_path, force=True,
                           global_batch=batch, seq_len=seq)
    assert rec["n_devices"] == {"single": 256, "multi": 512}[mesh_name]
    assert "note" not in rec
    cost, coll, mem = rec["cost"], rec["collectives"], rec["memory"]
    assert cost["flops_per_device"] > 0 and cost["bytes_accessed_per_device"] > 0
    assert set(coll) == set(COLL_OPS) | {"total_operand_bytes", "total_wire_bytes"}
    assert coll["total_wire_bytes"] == sum(coll[op]["wire_bytes"] for op in COLL_OPS) > 0
    cfg = registry.get_config(arch)
    want = dryrun.sharded_memory(cfg, shape, dryrun.make_mesh(mesh_name), batch, seq)
    scalar = 0 if shape == "prefill_32k" else 4  # the int32 AdamW step / decode position
    assert mem["argument_bytes_per_device"] == want["argument_bytes_per_device"] + scalar
    assert mem["peak_bytes_per_device"] >= mem["argument_bytes_per_device"]
    assert cost["flops_per_device"] * rec["n_devices"] >= card["cost"]["flops_per_device"]


@pytest.mark.parametrize("arch", registry.ARCHS)
def test_paths_that_do_not_run_sharded_refuse_dtensors(arch):
    """Each arch's smoke prefill on DTensors over a fake (2, 2) group on
    ``meta``: every arch is of ``transformer.runs_sharded`` (every mixer,
    FFN and frontend) and its prefill runs, giving the (B, 1, V) logits,
    (B, 1, K, V) for audio; the one path that still refuses DTensors, the
    mqr-KV sparse decode, is held by
    :func:`test_the_mqr_sparse_decode_refuses_dtensors`."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(registry.get_config(arch, smoke=True), head_dim=64)
    assert T.runs_sharded(cfg)
    k = (cfg.n_codebooks,) if cfg.frontend == "audio_codebooks" else ()
    with fake_group(4):
        mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
        args = dryrun.place_args(dryrun.cell_args(cfg, "prefill_32k", 4, 128), "prefill", mesh)
        step = dryrun.step_fn(cfg, "prefill_32k")
        with torch.inference_mode():
            out = step(*args)
        assert isinstance(out, DTensor) and out.shape == (4, 1, *k, cfg.padded_vocab)


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_moe_ffn_constrains_xe_and_ye_as_the_reference(runs, monkeypatch, dispatch):
    """The smoke MoE FFN on DTensors over a fake (2, 2) group on ``meta``
    (x (B, 16, 64) with B 4 and 3, the parameters placed by the rules):
    in each dispatch both the dispatched tokens xe and the expert outputs
    ye (B, E, C, D) leave ``shard`` with the placements of the spec the
    reference's ``shard`` leaves for them (JAX's output sharding on a (2,
    2) mesh), batch over ``data`` where it divides, experts over
    ``model``."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import steps
    from repro_torch.models import moe

    seen = []
    real = moe.shard

    def spy(x, *spec):
        y = real(x, *spec)
        seen.append((tuple(y.shape), tuple(y.placements)))
        return y

    monkeypatch.setattr(moe, "shard", spy)
    _, cfg = family_cfgs("granite_moe_1b", moe_dispatch=dispatch)
    with fake_group(4):
        mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
        params = moe.init_moe(torch.device("meta"), cfg, cfg.d_model)
        params = steps.place(params, rules.param_shardings(params, mesh), mesh)
        for shape, want in zip(MOE_SHAPES, runs["ref"]["moe_specs"], strict=True):
            xshape = (shape[0], 16, cfg.d_model)
            x = meta_dtensor(xshape, mesh, rules.placements(rules.clean_spec(
                (("pod", "data"), None, None), xshape, mesh), mesh))
            seen.clear()
            y, aux = moe.moe_ffn(params, cfg, x)
            want = rules.placements(rules.PartitionSpec(
                *[tuple(e) if isinstance(e, list) else e for e in want]), mesh)
            assert seen == [(shape, want), (shape, want)], (shape, seen)
            assert y.shape == xshape and aux["expert_load"].shape == (cfg.n_experts,)


@pytest.mark.parametrize("arch", ["llama32_1b", "deepseek_v3_671b"])
def test_the_mqr_sparse_decode_refuses_dtensors(arch):
    """The mqr-KV sparse decode step (long_500k) of the attention and the
    MLA mixer on DTensors over a fake (2, 2) group on ``meta`` raises
    ``NotImplementedError`` naming ROADMAP A4d."""
    from torch.distributed.device_mesh import init_device_mesh

    cfg = dataclasses.replace(registry.get_config(arch, smoke=True), head_dim=64)
    assert dryrun.mqr_sparse(cfg, "long_500k")
    with fake_group(4):
        mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
        args = dryrun.place_args(dryrun.cell_args(cfg, "long_500k", 4, 256), "decode", mesh)
        step = dryrun.step_fn(cfg, "long_500k")
        with torch.inference_mode(), pytest.raises(NotImplementedError, match="A4d"):
            step(*args)


def test_dry_run_keeps_argument_bytes_where_the_step_does_not_run_sharded(tmp_path):
    """The mqr-KV sparse decode, of the attention and the MLA mixer, keeps
    the rules' argument bytes, with a note naming ROADMAP A4d and nothing
    counted."""
    rec = dryrun.run_cell("llama32_1b", "long_500k", "single", tmp_path, force=True)
    assert rec["cost"] is None and rec["collectives"] is None and "A4d" in rec["note"]
    rec = dryrun.run_cell("deepseek_v3_671b", "long_500k", "multi", tmp_path, force=True)
    assert rec["cost"] is None and rec["memory"]["argument_bytes_per_device"] > 0
