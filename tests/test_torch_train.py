"""The port's training slice (``repro_torch.optim``, ``data``,
``checkpoint.CheckpointManager``, ``ft.straggler``, ``models.transformer
.loss_and_aux``, ``launch.steps.make_train_step``, ``launch.train``) held
to the JAX package's on the CPU.

The same parameters go to both sides (the reference's ``init_params``
carried across by ``convert.params_from_numpy``, its AdamW state by
``convert.opt_state_from_numpy``) and the same batches from a numpy seed.
Tolerances, float32 throughout: the loss within 1e-5 relative; each
gradient leaf within 1e-4 x its largest |jax| entry (the recurrent
families, whose chunk sums and scans run in another order than XLA's,
1e-3); AdamW's parameters and moments within 1e-6 relative + 1e-7 (one
float32 rounding of the same steps); EF-int8's int8 values and data
batches exactly equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ckpt
from repro.configs import registry as ref_registry
from repro.data import pipeline as ref_pipeline
from repro.ft import straggler as ref_straggler
from repro.ft.failures import InjectedFailure as RefInjectedFailure
from repro.launch import steps as ref_steps
from repro.models import transformer as ref_T
from repro.optim import adamw as ref_adamw
from repro.optim import compress as ref_compress
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import checkpoint as ckpt_mod
from repro_torch.configs import registry
from repro_torch.data import DataConfig, SyntheticLM, make_batch_fn
from repro_torch.ft import InjectedFailure, StragglerMonitor
from repro_torch.launch import steps
from repro_torch.launch.train import train
from repro_torch.models import transformer as T
from repro_torch.models.modules import tree_leaves
from repro_torch.optim import (
    AdamWConfig,
    AdamWState,
    apply_updates,
    clip_by_global_norm,
    ef_int8_compress,
    ef_int8_state,
    global_norm,
    init_state,
    lr_schedule,
)

CPU = "cpu"
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
SCAN_GRAD_RTOL = {"mamba2_2p7b": 1e-3, "recurrentgemma_9b": 1e-3}
GRAD_ARCHS = ("llama32_1b", "granite_moe_1b", "deepseek_v3_671b", "mamba2_2p7b", "internvl2_2b")


def cfg_pair(arch, **over):
    over.setdefault("dtype", "float32")
    return (dataclasses.replace(ref_registry.get_config(arch, smoke=True), **over),
            dataclasses.replace(registry.get_config(arch, smoke=True), **over))


@functools.lru_cache(maxsize=None)
def ref_params(ref_cfg, seed=0):
    return jax.jit(lambda key: ref_T.init_params(key, ref_cfg))(jax.random.PRNGKey(seed))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def params_pair(ref_cfg, cfg, seed=0):
    p = ref_params(ref_cfg, seed)
    return p, convert.params_from_numpy(np_tree(p), cfg, device=CPU)


def batch_of(cfg, b, s, seed):
    """Tokens and next-token labels of ``s`` positions (a vision model's
    patches among them), the first three labels of row 0 ignored (-1)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_codebooks":
        toks = rng.integers(0, cfg.vocab_size, (b, s + 1, cfg.n_codebooks)).astype(np.int32)
        labels = toks[:, 1:].copy()
        labels[0, :3, 1] = -1
        return {"tokens": toks[:, :-1], "labels": labels}
    st = s - cfg.n_patches if cfg.frontend == "vision_patches" else s
    toks = rng.integers(0, cfg.vocab_size, (b, st + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    out = {"tokens": toks[:, :-1], "labels": labels}
    if cfg.frontend == "vision_patches":
        out["vision_embeds"] = rng.standard_normal((b, cfg.n_patches, cfg.d_model)).astype(
            np.float32)
    return out


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def close_grads(got_leaves, want_tree, cfg, rtol):
    """Each port gradient within rtol x the largest |jax| entry of its leaf;
    a ``None`` (a parameter the loss never reads) where jax.grad gives zeros."""
    want = tree_leaves(convert.params_from_numpy(np_tree(want_tree), cfg, device=CPU))
    assert len(got_leaves) == len(want)
    for g, w in zip(got_leaves, want):
        if g is None:
            assert float(w.abs().max()) == 0.0
            continue
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(), rtol=0, atol=rtol * scale)


# -- loss_and_aux and gradients -------------------------------------------


@pytest.mark.parametrize("arch", registry.ARCHS)
def test_loss_and_aux_matches_reference(arch):
    """Loss, expert load and token count of every config at the smoke size,
    float32, against the reference's ``loss_and_aux``."""
    ref_cfg, cfg = cfg_pair(arch)
    ref_p, p = params_pair(ref_cfg, cfg)
    batch = batch_of(ref_cfg, 2, 32, seed=1)
    loss, aux = jax.jit(lambda pp, bb: ref_T.loss_and_aux(pp, ref_cfg, bb))(
        ref_p, jax_batch(batch))
    with torch.no_grad():
        ploss, paux = T.loss_and_aux(p, cfg, torch_batch(batch))
    np.testing.assert_allclose(float(ploss), float(loss), rtol=LOSS_RTOL)
    np.testing.assert_array_equal(paux["expert_load"].numpy(), np.asarray(aux["expert_load"]))
    assert int(paux["n_tokens"]) == int(aux["n_tokens"])


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_gradients_match_jax_grad(arch):
    """Every parameter's gradient against ``jax.grad`` of the reference's
    loss: llama, granite-moe (MoE routing), DeepSeek-V3 (MLA, two stacks,
    the MTP parameters the loss never reads: None here, zeros there), mamba2
    (SSD) and internvl2 (the vision prefix)."""
    ref_cfg, cfg = cfg_pair(arch)
    ref_p, p = params_pair(ref_cfg, cfg)
    batch = batch_of(ref_cfg, 2, 32, seed=2)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda pp: ref_T.loss_and_aux(pp, ref_cfg, jax_batch(batch)), has_aux=True))(ref_p)
    leaves = tree_leaves(p)
    for leaf in leaves:
        leaf.requires_grad_(True)
    ploss, _ = T.loss_and_aux(p, cfg, torch_batch(batch))
    got = torch.autograd.grad(ploss, leaves, allow_unused=True)
    np.testing.assert_allclose(float(ploss.detach()), float(loss), rtol=LOSS_RTOL)
    close_grads(got, grads, cfg, SCAN_GRAD_RTOL.get(arch, GRAD_RTOL))
    if cfg.mtp_depth:
        n_mtp = len(tree_leaves(p["mtp"]))
        mtp_ids = {id(t) for t in tree_leaves(p["mtp"])}
        assert sum(g is None for g, t in zip(got, leaves) if id(t) in mtp_ids) == n_mtp


@pytest.mark.parametrize("policy", ("full", "dots"))
def test_remat_gives_the_gradients_of_no_remat(policy):
    """Activation checkpointing of each superblock (and the tail) changes no
    gradient: recomputation repeats the same float32 operations."""
    _, cfg = cfg_pair("recurrentgemma_9b")  # a block pattern of 3, and a tail of 2
    cfg = dataclasses.replace(cfg, n_layers=5, tail_pattern=("rglru", "local"))
    p = T.init_params(0, cfg, device=CPU)
    batch = torch_batch(batch_of(cfg, 2, 64, seed=3))
    grads = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        leaves = tree_leaves(p)
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss, _ = T.loss_and_aux(p, c, batch)
        grads[remat] = torch.autograd.grad(loss, leaves, allow_unused=True)
    for a, b in zip(grads[False], grads[True]):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


# -- AdamW, clipping, the schedule, EF-int8 ----------------------------------


def _opt_trees(seed, n_steps, dtype=np.float32):
    """A small parameter tree (a dict with a list, as the port keeps
    superblocks) and ``n_steps`` gradient trees, numpy."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "blocks": [{"w": (4, 6)}, {"w": (4, 6)}], "z": (3,)}

    def draw(scale):
        return jax.tree.map(lambda s: (scale * rng.standard_normal(s)).astype(dtype), shapes,
                            is_leaf=lambda x: isinstance(x, tuple))
    return draw(1.0), [draw(0.5 * (i + 1)) for i in range(n_steps)]


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _close_tree(got, want, rtol=1e-6, atol=1e-7):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.detach().float().numpy(), np.asarray(w, np.float32),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("moments", ("float32", "bfloat16"))
def test_apply_updates_matches_reference_over_steps(moments):
    """Six AdamW steps (warmup and cosine, clipping active on the larger
    gradients, weight decay) from the same parameters and gradients: the
    parameters, both moments, the step, grad_norm and lr agree."""
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=1.5,
                      moments_dtype=moments)
    params, grads = _opt_trees(0, 6)
    ref_p = jax.tree.map(jnp.asarray, params)
    ref_s = ref_adamw.init_state(ref_p, ref_adamw.AdamWConfig(**dataclasses.asdict(cfg)))
    p = _to_torch(params)
    s = init_state(p, cfg)
    ref_apply = jax.jit(lambda pp, gg, ss: ref_adamw.apply_updates(
        pp, gg, ss, ref_adamw.AdamWConfig(**dataclasses.asdict(cfg))))
    for g in grads:
        ref_p, ref_s, ref_m = ref_apply(ref_p, jax.tree.map(jnp.asarray, g), ref_s)
        p, s, m = apply_updates(p, _to_torch(g), s, cfg)
        np.testing.assert_allclose(float(m["grad_norm"]), float(ref_m["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(ref_m["lr"]), rtol=1e-6)
        assert int(s.step) == int(ref_s.step)
        _close_tree(p, ref_p)
        _close_tree(s.m, ref_s.m, rtol=1e-2 if moments == "bfloat16" else 1e-6)
        _close_tree(s.v, ref_s.v, rtol=1e-2 if moments == "bfloat16" else 1e-6)
    assert tree_leaves(s.m)[0].dtype == {"float32": torch.float32,
                                         "bfloat16": torch.bfloat16}[moments]


def test_apply_updates_treats_a_none_gradient_as_zero():
    """A leaf the loss never reads (None here, zeros under jax.grad) decays
    its weight and its moments as the reference's zero gradient does."""
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    params, grads = _opt_trees(1, 3)
    p, s = _to_torch(params), None
    s = init_state(p, cfg)
    ref_p = jax.tree.map(jnp.asarray, params)
    rcfg = ref_adamw.AdamWConfig(**dataclasses.asdict(cfg))
    ref_s = ref_adamw.init_state(ref_p, rcfg)
    for g in grads:
        g["z"] = np.zeros_like(g["z"])
        ref_p, ref_s, _ = ref_adamw.apply_updates(ref_p, jax.tree.map(jnp.asarray, g), ref_s, rcfg)
        tg = _to_torch(g)
        tg["z"] = None
        p, s, _ = apply_updates(p, tg, s, cfg)
    _close_tree(p, ref_p)
    assert not np.allclose(p["z"].numpy(), params["z"])  # weight decay moved it


def test_schedule_clip_and_global_norm_match_reference():
    cfg = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=50, min_lr_ratio=0.2)
    rcfg = ref_adamw.AdamWConfig(**dataclasses.asdict(cfg))
    for step in (0, 1, 5, 10, 11, 30, 49, 50, 80):
        np.testing.assert_allclose(
            float(lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))),
            float(ref_adamw.lr_schedule(rcfg, jnp.int32(step))), rtol=1e-6)
    _, grads = _opt_trees(2, 1)
    for max_norm in (0.5, 1e3):
        want, wnorm = ref_adamw.clip_by_global_norm(jax.tree.map(jnp.asarray, grads[0]), max_norm)
        got, gnorm = clip_by_global_norm(_to_torch(grads[0]), max_norm)
        np.testing.assert_allclose(float(gnorm), float(wnorm), rtol=1e-6)
        _close_tree(got, want)
    np.testing.assert_allclose(float(global_norm(_to_torch(grads[0]))),
                               float(ref_adamw.global_norm(jax.tree.map(jnp.asarray, grads[0]))),
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_ef_int8_compress_matches_reference_over_steps(dtype):
    """Four steps of EF-int8: the int8 values (round half to even in both)
    and the dequantized gradients and residuals are equal."""
    import ml_dtypes

    _, grads = _opt_trees(3, 4)
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    grads = [jax.tree.map(lambda a: a.astype(np_dt), g) for g in grads]
    # ties of the rounding: entries at exact half steps of the scale
    grads[0]["z"] = np.array([127.0, 0.5, -2.5], np.float32).astype(np_dt)
    ref_e = ref_compress.ef_int8_state(jax.tree.map(jnp.asarray, grads[0]))
    e = ef_int8_state(_to_torch(grads[0]))
    for g in grads:
        want, ref_e = ref_compress.ef_int8_compress(jax.tree.map(jnp.asarray, g), ref_e)
        got, e = ef_int8_compress(_to_torch(g), e)
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
        for a, b in zip(tree_leaves(e), jax.tree.leaves(ref_e)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # a None gradient is a float32 zero gradient
    e0 = {"x": torch.tensor([1.0, -3.0, 0.7])}
    got, new_e = ef_int8_compress({"x": None}, e0)
    want, want_e = ef_int8_compress({"x": torch.zeros(3)}, e0)
    assert got["x"].dtype == torch.float32
    assert torch.equal(got["x"], want["x"]) and torch.equal(new_e["x"], want_e["x"])


# -- data, straggler, checkpoints -----------------------------------------


@pytest.mark.parametrize("cfg", [
    dict(vocab_size=256, seq_len=64, global_batch=4),
    dict(vocab_size=128_256, seq_len=128, global_batch=4, n_shards=2, shard_id=1, seed=7),
    dict(vocab_size=1000, seq_len=32, global_batch=3, motif_len=8, n_motifs=5, zipf_a=1.1),
])
def test_synthetic_lm_batches_are_bit_equal(cfg):
    ours, ref = SyntheticLM(DataConfig(**cfg)), ref_pipeline.SyntheticLM(
        ref_pipeline.DataConfig(**cfg))
    np.testing.assert_array_equal(ours.motifs, ref.motifs)
    fn, ref_fn = make_batch_fn(DataConfig(**cfg)), ref_pipeline.make_batch_fn(
        ref_pipeline.DataConfig(**cfg))
    for step in (0, 1, 17):
        a, b = fn(step), ref_fn(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    for a, b in zip(iter(ours), iter(ref)):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        break


def test_straggler_monitor_flags_what_the_reference_flags():
    rng = np.random.default_rng(4)
    times = list(0.1 + 0.01 * rng.random(40))
    times[15], times[27], times[28] = 0.5, 0.9, 0.25
    ours, ref = StragglerMonitor(window=20, min_samples=10), ref_straggler.StragglerMonitor(
        window=20, min_samples=10)
    seen = []
    ours.on_straggler = seen.append
    for step, t in enumerate(times):
        assert ours.observe(step, t) == ref.observe(step, t)
    assert [dataclasses.astuple(e) for e in ours.events] == [
        dataclasses.astuple(e) for e in ref.events]
    assert len(seen) == len(ours.events) == 3


def _state_tree():
    g = torch.Generator().manual_seed(5)
    params = {"embed": torch.randn(6, 4, generator=g).to(torch.bfloat16),
              "blocks": [{"w": torch.randn(4, 4, generator=g)},
                         {"w": torch.randn(4, 4, generator=g)}],
              "count": torch.arange(3, dtype=torch.int32)}
    opt = AdamWState(step=torch.tensor(7, dtype=torch.int32),
                     m={"embed": torch.randn(6, 4, generator=g), "blocks": [
                         {"w": torch.randn(4, 4, generator=g)}, {"w": torch.zeros(4, 4)}]},
                     v={"embed": torch.rand(6, 4, generator=g), "blocks": [
                         {"w": torch.rand(4, 4, generator=g)}, {"w": torch.ones(4, 4)}]})
    return {"params": params, "opt": opt}


def _zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    if isinstance(tree, AdamWState):
        return AdamWState(*(_zeros_like_tree(v) for v in tree))
    if isinstance(tree, list):
        return [_zeros_like_tree(v) for v in tree]
    return torch.zeros_like(tree)


def _assert_bit_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)


def test_checkpoint_round_trip_and_the_reference_key_rule(tmp_path):
    """bf16, float32 and int32 leaves, a list and a NamedTuple come back bit
    for bit in their template's dtypes; bf16 is stored as float32; keys follow
    the reference's rule (dict key, list index, field name joined by /)."""
    tree = _state_tree()
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(3, tree, {"loss": 1.5})
    back = mgr.restore(3, _zeros_like_tree(tree))
    _assert_bit_equal(back, tree)
    assert isinstance(back["opt"], AdamWState) and isinstance(back["params"]["blocks"], list)
    assert mgr.metadata(3) == {"step": 3, "loss": 1.5}
    with np.load(tmp_path / "step_00000003" / "shard0.npz") as z:
        keys, embed = set(z.files), z["params/embed"]
    assert embed.dtype == np.float32
    ref_tree = jax.tree.map(lambda t: np.asarray(t.float().numpy()), tree,
                            is_leaf=lambda x: isinstance(x, torch.Tensor))
    ref_tree["opt"] = ref_adamw.AdamWState(*ref_tree["opt"])
    assert keys == set(ref_ckpt._flatten(ref_tree))


def test_checkpoint_publish_is_atomic(tmp_path, monkeypatch):
    """A write that dies before its rename leaves no restorable step; the
    next save publishes, and auto-resume picks the latest."""
    tree = _state_tree()
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, tree)

    def crash(src, dst):
        raise OSError("killed mid-publish")

    monkeypatch.setattr(ckpt_mod.os, "replace", crash)
    with pytest.raises(OSError):
        mgr.save(2, tree)
    monkeypatch.undo()
    assert mgr.all_steps() == [1] and mgr.latest_step() == 1
    assert (tmp_path / "tmp.2.0").exists()
    mgr.save(2, tree)
    assert mgr.latest_step() == 2


def test_checkpoint_keeps_the_last_k_and_saves_async(tmp_path):
    """keep=2 leaves the last two steps; an async save copies the leaves to
    the host before its thread runs, so updating them in place at once does
    not reach the checkpoint."""
    tree = _state_tree()
    want = _zeros_like_tree(tree)
    for a, b in zip(tree_leaves(want), tree_leaves(tree)):
        a.copy_(b)
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    for step in range(1, 6):
        mgr.save(step, tree)
        tree["params"]["blocks"][0]["w"].add_(1.0)  # the loop's next in-place update
    mgr.wait()
    assert sorted(mgr.all_steps()) == [4, 5]
    back = CheckpointManager(str(tmp_path)).restore(4, _zeros_like_tree(tree))
    assert torch.equal(back["params"]["blocks"][0]["w"],
                       want["params"]["blocks"][0]["w"] + 1.0 + 1.0 + 1.0)  # the first three adds


# -- train step and the driver -------------------------------------------


def test_make_train_step_matches_reference_over_five_steps():
    """Five steps of ``make_train_step`` from the reference's parameters and
    AdamW state on the same synthetic batches: loss, grad_norm, lr and the
    final parameters agree (1e-4 relative; parameters also 1e-4 absolute:
    Adam divides each update by sqrt(v), so an entry whose gradient is near
    zero moves by its float32 noise times the learning rate, 1e-2)."""
    ref_cfg, cfg = cfg_pair("llama32_1b")
    opt_cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    rcfg = ref_adamw.AdamWConfig(**dataclasses.asdict(opt_cfg))
    ref_p, p = params_pair(ref_cfg, cfg, seed=3)
    ref_s = ref_adamw.init_state(ref_p, rcfg)
    s = convert.opt_state_from_numpy(np_tree(ref_s), cfg, device=CPU)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2))
    ref_step = jax.jit(ref_steps.make_train_step(ref_cfg, rcfg))
    step = steps.make_train_step(cfg, opt_cfg)
    for i in range(5):
        b = data.batch(i)
        ref_p, ref_s, rm = ref_step(ref_p, ref_s, jax_batch(b))
        p, s, m = step(p, s, torch_batch(b))
        for key in ("loss", "grad_norm", "lr", "expert_load_max"):
            np.testing.assert_allclose(float(m[key]), float(rm[key]), rtol=1e-4, err_msg=key)
    want = tree_leaves(convert.params_from_numpy(np_tree(ref_p), cfg, device=CPU))
    for a, b in zip(tree_leaves(p), want):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def test_train_step_with_grad_compress_and_a_none_gradient():
    """DeepSeek (MTP parameters never read) with EF-int8: the step runs, the
    EF state covers every parameter, and the MTP weights decay."""
    _, cfg = cfg_pair("deepseek_v3_671b")
    opt_cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=3)
    p = T.init_params(0, cfg, device=CPU)
    s = init_state(p, opt_cfg)
    ef = ef_int8_state(p)
    mtp0 = tree_leaves(p["mtp"])[0].detach().clone()
    step = steps.make_train_step(cfg, opt_cfg, grad_compress=True)
    b = torch_batch(batch_of(cfg, 1, 16, seed=4))
    p, s, ef, m = step(p, s, b, ef)
    assert np.isfinite(float(m["loss"])) and float(m["expert_load_max"]) > 0
    assert len(tree_leaves(ef)) == len(tree_leaves(p))
    assert not torch.equal(tree_leaves(p["mtp"])[0], mtp0)


def test_opt_state_from_numpy_and_abstract_trees_match_the_reference():
    ref_cfg, cfg = cfg_pair("deepseek_v3_671b")
    rcfg = ref_adamw.AdamWConfig(moments_dtype="bfloat16")
    ref_s = ref_adamw.init_state(ref_params(ref_cfg), rcfg)
    s = convert.opt_state_from_numpy(np_tree(ref_s), cfg, device=CPU)
    assert int(s.step) == 0 and s.step.dtype == torch.int32
    assert {t.dtype for t in tree_leaves(s.m) + tree_leaves(s.v)} == {torch.bfloat16}
    abs_p = steps.abstract_params(cfg)
    abs_s = steps.abstract_opt_state(abs_p, AdamWConfig())
    ref_abs = ref_steps.abstract_params(ref_cfg)  # stacked: one leaf a (superblock) stack
    assert {(a.shape[1:], a.dtype.name) for a in jax.tree.leaves(ref_abs["blocks"])} == {
        (tuple(t.shape), str(t.dtype).removeprefix("torch."))
        for t in tree_leaves(abs_p["blocks"][0])}
    assert all(t.device.type == "meta" for t in tree_leaves(abs_p) + tree_leaves(abs_s.m))
    want = tree_leaves(convert.params_from_numpy(np_tree(ref_params(ref_cfg)), cfg, device=CPU))
    for a, b, m in zip(tree_leaves(abs_p), want, tree_leaves(abs_s.m)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert m.shape == b.shape and m.dtype == torch.float32
    with pytest.raises(TypeError, match="moments"):
        bad = ref_s._replace(m=jax.tree.map(lambda a: a.astype(jnp.int32), ref_s.m))
        convert.opt_state_from_numpy(np_tree(bad), cfg, device=CPU)


def test_training_loss_decreases():
    """The counterpart of tests/test_system.py::test_training_loss_decreases
    on the port, on the CPU."""
    losses = train(arch="llama32_1b", smoke=True, steps=60, batch=8, seq=64,
                   log_every=0, lr=2e-3, d_model=128, n_layers=2, device=CPU)
    first, last = losses[:10].mean(), losses[-10:].mean()
    assert last < first - 0.5, (first, last)


def test_failure_injection_and_training_resume(tmp_path):
    """The counterpart of tests/test_ft.py::test_failure_injection_and_training_resume:
    train crashes at an injected step, restarts, resumes from the checkpoint."""
    kw = dict(arch="llama32_1b", smoke=True, steps=30, batch=2, seq=32,
              ckpt_dir=str(tmp_path), ckpt_every=10, log_every=0, d_model=64, n_layers=2,
              device=CPU)
    with pytest.raises(InjectedFailure):
        train(fail_at_step=15, **kw)
    assert CheckpointManager(str(tmp_path)).latest_step() == 10
    losses = train(**kw)
    assert len(losses) == 20  # 30 - resumed 10
    assert InjectedFailure is not RefInjectedFailure  # the port's own class


def test_resumed_training_repeats_the_uninterrupted_losses(tmp_path):
    """A run saved at step 5 and resumed repeats the uninterrupted run's
    losses of steps 5-9 exactly (float32 on the CPU)."""
    kw = dict(arch="llama32_1b", smoke=True, steps=10, batch=2, seq=32, log_every=0,
              d_model=64, n_layers=2, device=CPU)
    whole = train(**kw)
    with pytest.raises(InjectedFailure):
        train(ckpt_dir=str(tmp_path), ckpt_every=5, fail_at_step=6, **kw)
    resumed = train(ckpt_dir=str(tmp_path), ckpt_every=5, **kw)
    np.testing.assert_array_equal(resumed, whole[5:])
