"""The port's models (``repro_torch.models``, ``repro_torch.configs``) held to
the JAX package's on the CPU, at the smoke size of ``scale_for_smoke`` (2
layers, d_model 64, head dim 16).

The same parameters go to both sides (the reference's ``init_params``
carried across by ``convert.params_from_numpy``), and the same inputs from
a numpy seed.  Tolerances: a float32 config (``dtype="float32"``) within
``1e-5 + 1e-4 |jax|`` (the two libraries sum matrix products in other
orders); bfloat16 within the reference's own gates,
``tests/test_decode_consistency.py``: 0.25 decode against forward, 0.05
sparse against dense.  The port's caches are (B, Hkv, S, Dh) where the
reference's are (B, S, Hkv, Dh) (ROADMAP C24): caches are compared through
a transpose.  The Mamba-2 and RG-LRU families sum their SSD chunks and
their scan in another order than XLA: ``1e-4 + 1e-3 |jax|`` for them
(``tests/test_torch_families.py`` holds each module alone).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.core import kvindex as ref_kv
from repro.models import attention as ref_attn
from repro.models import modules as ref_mod
from repro.models import transformer as ref_T
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.models import attention as attn
from repro_torch.models import modules
from repro_torch.models import transformer as T

CPU = "cpu"
PORTED = registry.ARCHS
# What the port still lacks of the model: nothing (training, loss_and_aux,
# is held to the reference in tests/test_torch_train.py).
UNPORTED = ()
# the float32 tolerance: |port - jax| <= ATOL + RTOL |jax|
ATOL, RTOL = 1e-5, 1e-4
# the recurrent families' (SSD chunk sums, the RG-LRU scan)
SCAN = {"mamba2_2p7b": (1e-4, 1e-3), "recurrentgemma_9b": (1e-4, 1e-3)}
# the reference stacks these on a leading axis; the port keeps lists
STACKED = ("blocks", "blocks_dense", "mtp")
# a weight of each mixer kind drawn fan-in scaled over d_model
FAN_IN = {"attn": "wq", "local": "wq", "mla": "wq_a", "mamba2": "in_proj", "rglru": "in_x"}


def close32(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().to(torch.float32).numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol, rtol=rtol)


def max_err(got, want) -> float:
    return float(np.max(np.abs(got.to(torch.float32).numpy() - np.asarray(want, np.float32))))


def cfg_pair(arch="llama32_1b", **over):
    """The reference's smoke config and the port's, with the same overrides."""
    return (dataclasses.replace(ref_registry.get_config(arch, smoke=True), **over),
            dataclasses.replace(registry.get_config(arch, smoke=True), **over))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def ref_params(ref_cfg, seed=0):
    return jax.jit(lambda key: ref_T.init_params(key, ref_cfg))(jax.random.PRNGKey(seed))


def params_pair(ref_cfg, cfg, seed=0):
    p = ref_params(ref_cfg, seed)
    return p, convert.params_from_numpy(np_tree(p), cfg, device=CPU)


def leaf_at(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def t(a, dtype=None):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True))


def tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


# -- configs and parameters ---------------------------------------------------


@pytest.mark.parametrize("arch", registry.ARCHS)
def test_configs_and_param_count_equal_reference(arch):
    for smoke in (False, True):
        ref, port = ref_registry.get_config(arch, smoke), registry.get_config(arch, smoke)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
        assert (port.head_dim_, port.padded_vocab, port.n_superblocks) == (
            ref.head_dim_, ref.padded_vocab, ref.n_superblocks)


@pytest.mark.parametrize("arch", registry.ARCHS)
def test_init_params_shapes_equal_reference(arch):
    ref_cfg, cfg = ref_registry.get_config(arch, True), registry.get_config(arch, True)
    for name in UNPORTED:  # nothing of the model is left to port
        with pytest.raises(NotImplementedError, match="ROADMAP A4"):
            getattr(T, name)({}, cfg, {})
    want = jax.eval_shape(lambda: ref_T.init_params(jax.random.PRNGKey(0), ref_cfg))
    params = T.init_params(0, cfg, device=CPU)
    assert set(params) == set(want)
    for key in STACKED:
        if key in want:
            assert len(params[key]) == jax.tree.leaves(want[key])[0].shape[0]

    def check(got, spec, stacked):
        if isinstance(spec, dict):
            assert set(got) == set(spec)
            for k in spec:
                check(got[k], spec[k], stacked)
            return
        shape = spec.shape[1:] if stacked else spec.shape
        assert tuple(got.shape) == tuple(shape) and str(got.dtype)[6:] == spec.dtype.name

    for key in want:
        if key in STACKED:
            for b in params[key]:
                check(b, want[key], stacked=True)
        else:
            check(params[key], want[key], stacked=False)
    assert modules.count_params(params) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(want))
    # the truncated normal: within 2 sigma of zero, fan-in scaled
    w = params["blocks"][0]["l0"]["mixer"][FAN_IN[cfg.block_pattern[0]]].float()
    assert float(w.abs().max()) <= 2.0 / np.sqrt(cfg.d_model) * 1.01
    assert float(w.std()) == pytest.approx(0.88 / np.sqrt(cfg.d_model), rel=0.25)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_from_numpy_round_trip(dtype):
    ref_cfg, cfg = cfg_pair(dtype=dtype)
    ref_p, p = params_pair(ref_cfg, cfg)
    leaves = jax.tree_util.tree_leaves_with_path(ref_p["blocks"])
    assert len(leaves) == len(modules.tree_leaves(p["blocks"][0]))
    for i, block in enumerate(p["blocks"]):
        for path, want in leaves:
            got = leaf_at(block, path)
            assert got.dtype == modules.DTYPES[str(want.dtype)], path
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want[i], np.float32), err_msg=str(path))
    for key in ("embed", "final_norm"):
        assert p[key].dtype == modules.DTYPES[str(ref_p[key].dtype)]
        np.testing.assert_array_equal(p[key].float().numpy(), np.asarray(ref_p[key], np.float32))
    tree = np_tree(ref_p)
    bad = jax.tree.map(lambda a: a, tree)
    bad["embed"] = bad["embed"][:, :-1]
    with pytest.raises(ValueError, match="params/embed: shape"):
        convert.params_from_numpy(bad, cfg, device=CPU)
    bad = jax.tree.map(lambda a: a, tree)
    bad["final_norm"] = bad["final_norm"].astype(np.float64)
    with pytest.raises(TypeError, match="params/final_norm: dtype"):
        convert.params_from_numpy(bad, cfg, device=CPU)
    bad = jax.tree.map(lambda a: a, tree)
    del bad["blocks"]["l0"]["mixer"]["probe"]
    with pytest.raises(ValueError, match="keys"):
        convert.params_from_numpy(bad, cfg, device=CPU)
    bad = jax.tree.map(lambda a: a, tree)
    bad["blocks"] = jax.tree.map(lambda a: a[:1], bad["blocks"])
    with pytest.raises(ValueError, match="stack 2 superblocks"):
        convert.params_from_numpy(bad, cfg, device=CPU)


# -- modules ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    s = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    want = ref_mod.rmsnorm(jnp.asarray(s), jx, 1e-6)
    got = modules.rmsnorm(t(s), t(jx), 1e-6)
    assert got.dtype == modules.DTYPES[dtype] and got.shape == x.shape
    if dtype == "float32":
        close32(got, want)
    else:  # both round the same float32 result to bfloat16: one ulp at most
        close32(got, want, atol=0, rtol=2 ** -7)


@pytest.mark.parametrize("shape", [(2, 7, 3, 16), (4, 9, 32)])
def test_apply_rope_matches_reference(shape):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    pos = np.broadcast_to(np.arange(shape[1]) * 37, shape[:2]).astype(np.int32)
    for theta in (10000.0, 500000.0):
        want = ref_mod.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        close32(modules.apply_rope(t(x), t(pos), theta), want)
        close32(modules.rope_freqs(shape[-1], theta), ref_mod.rope_freqs(shape[-1], theta))


def test_act_fn_and_tree_helpers_match_reference():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    for kind in ("silu", "gelu", "relu"):
        close32(modules.act_fn(kind)(t(x)), ref_mod.act_fn(kind)(jnp.asarray(x)))
    tree = {"a": torch.ones(3), "b": [torch.zeros(2, 2), torch.arange(4)]}
    cast = modules.tree_cast(tree, torch.bfloat16)
    assert cast["a"].dtype == torch.bfloat16 and cast["b"][1].dtype == torch.int64
    assert modules.count_params(tree) == 11
    assert modules.shard(tree["a"], "data") is tree["a"]


# -- attention ----------------------------------------------------------------


def _qkv(seed, b, s, h, hkv, dh):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, dh), (b, s, hkv, dh), (b, s, hkv, dh)))


@pytest.mark.parametrize("s,window,chunk", [(40, None, 40), (128, None, 64), (40, 8, 8),
                                            (64, 16, 32)])
def test_flash_attention_matches_flash_attention_jnp(s, window, chunk):
    """Causal without a window: kernel #8's path (its plain version here),
    S padded to 128; with a window: the chunked online softmax."""
    q, k, v = _qkv(s, 2, s, 4, 2, 16)
    pos = np.broadcast_to(np.arange(s), (2, s)).astype(np.int32)
    want = ref_attn.flash_attention_jnp(*map(jnp.asarray, (q, k, v, pos, pos)),
                                        window=window, chunk=chunk)
    got = attn.flash_attention(t(q), t(k), t(v), t(pos), t(pos), window=window, chunk=chunk)
    assert got.shape == q.shape
    close32(got, want)


def test_local_attention_banded_matches_reference():
    q, k, v = _qkv(5, 2, 32, 4, 1, 16)
    pos = np.broadcast_to(np.arange(32), (2, 32)).astype(np.int32)
    want = ref_attn.local_attention_banded(*map(jnp.asarray, (q, k, v, pos)), 8)
    close32(attn.local_attention_banded(t(q), t(k), t(v), t(pos), 8), want)


def _mixer_pair(ref_cfg, seed=3):
    p = ref_attn.init_attention(jax.random.PRNGKey(seed), ref_cfg, ref_cfg.d_model)
    return p, {k: t(v) for k, v in p.items()}


def _filled_cache(ref_cfg, b, s, upto, seed):
    """A reference cache with random keys and values in positions < upto,
    and the port's copy of it (C24 layout)."""
    ref = ref_attn.init_kv_cache(ref_cfg, b, s, jnp.float32)
    rng = np.random.default_rng(seed)
    kv = rng.standard_normal((2, b, s, ref_cfg.n_kv_heads, ref_cfg.head_dim_)).astype(np.float32)
    kv[:, :, upto:] = 0
    ref = dict(ref, k=jnp.asarray(kv[0]), v=jnp.asarray(kv[1]))
    port = attn.init_kv_cache(ref_cfg, b, s, torch.float32, torch.device(CPU))
    port["k"].copy_(t(kv[0]).transpose(1, 2))
    port["v"].copy_(t(kv[1]).transpose(1, 2))
    return ref, port


def close_cache(port, ref):
    close32(port["k"].transpose(1, 2), ref["k"])
    close32(port["v"].transpose(1, 2), ref["v"])


@pytest.mark.parametrize("mode", ["dense", "sparse", "sparse_all"])
def test_attention_decode_matches_reference(mode):
    """Dense decode, and the sparse decode (batched build + select, then #9's
    plain version with group H / Hkv) with top-K 4 of 8 blocks (pruning) and
    of 4 (every block), at several positions of a filled cache."""
    s = 128 if mode == "sparse" else 64
    ref_cfg, cfg = cfg_pair(dtype="float32", mqr_block=16, mqr_topk=4)
    ref_p, p = _mixer_pair(ref_cfg)
    b = 2
    x = np.random.default_rng(4).standard_normal((b, 1, 64)).astype(np.float32)
    decode = jax.jit(lambda pp, xx, cc, pos: ref_attn.attention_decode(
        pp, ref_cfg, xx, cc, pos, mqr_sparse=mode != "dense"))
    for pos in (s - 37, s - 1, 17):
        ref_c, c = _filled_cache(ref_cfg, b, s, pos, seed=pos)
        want, ref_c = decode(ref_p, jnp.asarray(x), ref_c, pos)
        got, c = attn.attention_decode(p, cfg, t(x), c, pos, mqr_sparse=mode != "dense")
        close32(got, want)
        close_cache(c, ref_c)


def test_sparse_block_ids_equal_reference_selection():
    """The model's batched selection: every query head's ids equal the
    reference's vmap of build_kv_index + select_blocks (keys on a small
    integer grid, so every float32 dot product is exact)."""
    ref_cfg, cfg = cfg_pair(dtype="float32", mqr_block=16, mqr_topk=3)
    rng = np.random.default_rng(6)
    b, hkv, s, dh, h = 2, 2, 128, 16, 4
    keys = rng.integers(-3, 4, (b, hkv, s, dh)).astype(np.float32)
    probe = rng.integers(-2, 3, (hkv, dh)).astype(np.float32)
    q = rng.integers(-2, 3, (b, 1, h, dh)).astype(np.float32)
    pos = s - 20
    got = attn.sparse_block_ids({"probe": t(probe)}, cfg, t(q), t(keys), pos)
    want = []
    for bi in range(b):
        for hi in range(h):
            g = hi // (h // hkv)
            ix = ref_kv.build_kv_index(jnp.asarray(keys[bi, g]), jnp.asarray(probe[g]), 16,
                                       ref_cfg.mqr_levels)
            region = ref_kv.query_region(jnp.asarray(q[bi, 0, hi]), jnp.asarray(probe[g]),
                                         pos + 1)
            want.append(np.asarray(ref_kv.select_blocks(ix, region, 3)))
    np.testing.assert_array_equal(got.numpy(), np.stack(want))


def test_incremental_decode_matches_reference():
    """The cache-resident incremental index, updated and searched batched
    over (batch, kv head), streamed over 24 tokens (two blocks of 16, top-K
    2 of 4): outputs, caches and the index state equal the reference's."""
    ref_cfg, cfg = cfg_pair(dtype="float32", mqr_block=16, mqr_topk=2, mqr_incremental=True)
    ref_p, p = _mixer_pair(ref_cfg)
    b, s = 2, 64
    ref_c = ref_attn.init_kv_cache(ref_cfg, b, s, jnp.float32)
    c = attn.init_kv_cache(cfg, b, s, torch.float32, torch.device(CPU))
    for name in ("idx_block", "idx_group", "idx_gof"):
        np.testing.assert_array_equal(c[name].numpy(), np.asarray(ref_c[name]))
    xs = np.random.default_rng(7).standard_normal((24, b, 1, 64)).astype(np.float32)
    decode = jax.jit(lambda pp, xx, cc, pos: ref_attn.attention_decode(
        pp, ref_cfg, xx, cc, pos, mqr_sparse=True))
    for pos in range(24):
        want, ref_c = decode(ref_p, jnp.asarray(xs[pos]), ref_c, pos)
        got, c = attn.attention_decode(p, cfg, t(xs[pos]), c, torch.tensor(pos),
                                       mqr_sparse=True)
        close32(got, want)
    close_cache(c, ref_c)
    close32(c["idx_block"], ref_c["idx_block"])
    close32(c["idx_group"], ref_c["idx_group"])


def test_local_attention_decode_matches_reference():
    """The ring buffer of a sliding-window layer, streamed past its wrap."""
    ref_cfg, cfg = cfg_pair(dtype="float32", local_window=8)
    ref_p, p = _mixer_pair(ref_cfg)
    b = 2
    ref_c = ref_attn.init_local_cache(ref_cfg, b, jnp.float32)
    c = attn.init_local_cache(cfg, b, torch.float32, torch.device(CPU))
    xs = np.random.default_rng(8).standard_normal((20, b, 1, 64)).astype(np.float32)
    decode = jax.jit(lambda pp, xx, cc, pos: ref_attn.local_attention_decode(
        pp, ref_cfg, xx, cc, pos))
    for pos in range(20):
        want, ref_c = decode(ref_p, jnp.asarray(xs[pos]), ref_c, pos)
        got, c = attn.local_attention_decode(p, cfg, t(xs[pos]), c, pos)
        close32(got, want)
    close_cache(c, ref_c)
    np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(ref_c["pos"]))


# -- the model ----------------------------------------------------------------


def _batch(ref_cfg, b, s, seed):
    if ref_cfg.frontend == "audio_codebooks":
        return {"tokens": tokens(seed, (b, s, ref_cfg.n_codebooks), ref_cfg.vocab_size)}
    if ref_cfg.frontend == "vision_patches":
        vis = np.random.default_rng(seed).standard_normal((b, ref_cfg.n_patches, 64))
        return {"tokens": tokens(seed, (b, s - ref_cfg.n_patches), ref_cfg.vocab_size),
                "vision_embeds": vis.astype(np.float32)}
    return {"tokens": tokens(seed, (b, s), ref_cfg.vocab_size)}


@pytest.mark.parametrize("arch", PORTED)
def test_forward_hidden_logits_and_prefill_match_reference(arch):
    """Every ported family at float32 (llama also at bfloat16 within the
    reference's 0.25 gate): embed_inputs, forward_hidden, logits_fn and
    prefill.  gemma scales its embeddings, musicgen has codebooks and an
    untied head, internvl vision patches, granite an untied head; the MoE
    families' expert loads are exactly the reference's."""
    for dtype in ("float32", "bfloat16") if arch == "llama32_1b" else ("float32",):
        ref_cfg, cfg = cfg_pair(arch, dtype=dtype)
        ref_p, p = params_pair(ref_cfg, cfg)
        batch = _batch(ref_cfg, 2, 24, seed=9)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        x, pos, mask = ref_T.embed_inputs(ref_p, ref_cfg, jb)
        px, ppos, pmask = T.embed_inputs(p, cfg, {k: t(v) for k, v in batch.items()})
        np.testing.assert_array_equal(ppos.numpy(), np.asarray(pos))
        np.testing.assert_array_equal(pmask.numpy(), np.asarray(mask))
        hidden, load = ref_T.forward_hidden(ref_p, ref_cfg, x, pos)
        phidden, pload = T.forward_hidden(p, cfg, px, ppos)
        assert pload.dtype == torch.float32
        np.testing.assert_array_equal(pload.numpy(), np.asarray(load))
        logits = ref_T.logits_fn(ref_p, ref_cfg, hidden)
        plogits = T.logits_fn(p, cfg, phidden)
        last = T.prefill(p, cfg, {k: t(v) for k, v in batch.items()})
        assert plogits.dtype == modules.DTYPES[dtype] and plogits.shape == logits.shape
        if dtype == "float32":
            tol = SCAN.get(arch, (ATOL, RTOL))
            close32(px, x)
            close32(phidden, hidden, *tol)
            close32(plogits, logits, *tol)
            close32(last, logits[:, -1:], *tol)
        else:
            assert max_err(plogits, logits) < 0.25
            assert max_err(last, logits[:, -1:]) < 0.25


def _decode_pair(arch, dtype, b=1, s=32, sparse=False, seed=1, **over):
    """Teacher-forced decode of the same tokens through both packages (the
    reference's step jitted once); returns the port's and the reference's
    logits (B, S, V...) and the port's final caches."""
    ref_cfg, cfg = cfg_pair(arch, dtype=dtype, **over)
    ref_p, p = params_pair(ref_cfg, cfg)
    toks = _batch(ref_cfg, b, s, seed)["tokens"]
    step = jax.jit(lambda pp, tk, c, pos: ref_T.decode_step(pp, ref_cfg, tk, c, pos,
                                                            mqr_sparse=sparse))
    ref_c = ref_T.init_caches(ref_cfg, b, s)
    c = T.init_caches(cfg, b, s, device=CPU)
    ref_out, out = [], []
    for i in range(s):
        lg, ref_c = step(ref_p, jnp.asarray(toks[:, i:i + 1]), ref_c, i)
        ref_out.append(np.asarray(lg, np.float32))
        plg, c = T.decode_step(p, cfg, t(toks[:, i:i + 1]), c, i, mqr_sparse=sparse)
        out.append(plg)
    return torch.cat(out, dim=1), np.concatenate(ref_out, axis=1), c, ref_c, (p, cfg, toks)


def close_layer_cache(kind, got, want, tol):
    """One layer's cache against the reference's: attention caches through
    the C24 transpose, the others as they are."""
    if kind in ("attn", "local"):
        close_cache(got, want)
        if kind == "local":
            np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))
        return
    assert set(got) == set(want)
    for name in got:
        close32(got[name], want[name], *tol)


@pytest.mark.parametrize("arch", ["llama32_1b", "musicgen_large", "granite_moe_1b",
                                  "deepseek_v3_671b", "mamba2_2p7b", "recurrentgemma_9b"])
def test_decode_step_teacher_forced_matches_reference(arch):
    """32 tokens through decode_step, float32: every step's logits within
    the float32 tolerance of the reference's, the caches of every layer too
    (DeepSeek's dense and MoE stacks, recurrentgemma's ring buffers and
    recurrent states); and the port's decode reproduces its own forward
    (the reference's property)."""
    got, want, c, ref_c, (p, cfg, toks) = _decode_pair(arch, "float32")
    tol = SCAN.get(arch, (ATOL, RTOL))
    close32(got, want, *tol)
    assert set(c) == set(ref_c)
    for stack in c:
        if stack == "tail":
            continue
        for i, layer in enumerate(c[stack]):
            for j, kind in enumerate(cfg.block_pattern):
                close_layer_cache(kind, layer[f"l{j}"],
                                  jax.tree.map(lambda a, i=i: a[i], ref_c[stack][f"l{j}"]), tol)
    x, pos, _ = T.embed_inputs(p, cfg, {"tokens": t(toks)})
    full = T.logits_fn(p, cfg, T.forward_hidden(p, cfg, x, pos)[0])
    close32(got, full.numpy(), atol=1e-4, rtol=1e-3)


def test_decode_bf16_and_sparse_gates_within_and_between_packages():
    """bfloat16 llama: decode against the forward within 0.25, sparse
    (top-K 4 of 4 blocks) against dense within 0.05, in the port and
    between the packages."""
    dense, ref_dense, _, _, (p, cfg, toks) = _decode_pair("llama32_1b", "bfloat16", s=64)
    sparse, ref_sparse, *_ = _decode_pair("llama32_1b", "bfloat16", s=64, sparse=True)
    x, pos, _ = T.embed_inputs(p, cfg, {"tokens": t(toks)})
    full = T.logits_fn(p, cfg, T.forward_hidden(p, cfg, x, pos)[0])
    assert max_err(dense, full.float().numpy()) < 0.25
    assert max_err(dense, ref_dense) < 0.25
    assert max_err(sparse[:, -1:], dense[:, -1:].float().numpy()) < 0.05
    assert max_err(sparse[:, -1:], ref_sparse[:, -1:]) < 0.05
    assert max_err(sparse, ref_dense) < 0.25


# gemma-2b's attention shape at a small size: 2 layers, d_model 512, 2 query
# heads of head dim 256 over 1 kv head (kernels #8 and #9 at D 256 on the card)
HD256 = dict(dtype="float32", n_layers=2, d_model=512, n_heads=2, n_kv_heads=1, head_dim=256,
             mqr_block=16, mqr_topk=2)


def test_head_dim_256_model_prefill_matches_reference():
    """forward_hidden, logits and prefill of the head-dim-256 model."""
    ref_cfg, cfg = cfg_pair("gemma_2b", **HD256)
    ref_p, p = params_pair(ref_cfg, cfg)
    batch = _batch(ref_cfg, 2, 48, seed=12)
    x, pos, _ = ref_T.embed_inputs(ref_p, ref_cfg, {k: jnp.asarray(v) for k, v in batch.items()})
    logits = ref_T.logits_fn(ref_p, ref_cfg, ref_T.forward_hidden(ref_p, ref_cfg, x, pos)[0])
    px, ppos, _ = T.embed_inputs(p, cfg, {k: t(v) for k, v in batch.items()})
    close32(T.logits_fn(p, cfg, T.forward_hidden(p, cfg, px, ppos)[0]), logits)
    close32(T.prefill(p, cfg, {k: t(v) for k, v in batch.items()}), logits[:, -1:])


@pytest.mark.parametrize("sparse", [False, True])
def test_head_dim_256_model_decode_matches_reference(sparse):
    """Teacher-forced decode of the head-dim-256 model, dense and mqr-KV
    sparse (top-K 2 of up to 4 blocks of 16: #9's plain version with group
    2 at D 256), every step's logits and the caches."""
    got, want, c, ref_c, _ = _decode_pair("gemma_2b", "float32", b=2, s=64, sparse=sparse,
                                          **{k: v for k, v in HD256.items() if k != "dtype"})
    close32(got, want)
    for i, layer in enumerate(c["all"]):
        close_layer_cache("attn", layer["l0"],
                          jax.tree.map(lambda a, i=i: a[i], ref_c["all"]["l0"]), (ATOL, RTOL))


def test_unported_mixers_raise_not_implemented():
    """Every mixer and FFN of the ten configs is ported, and training
    (``loss_and_aux``) runs for each: nothing raises ``NotImplementedError``
    any more; a mixer kind no config has raises ValueError, as in the
    reference."""
    assert UNPORTED == ()
    for arch in registry.ARCHS:
        cfg = registry.get_config(arch, smoke=True)
        b = _batch(cfg, 1, 16, seed=1)
        b["labels"] = b["tokens"]
        with torch.no_grad():
            loss, aux = T.loss_and_aux(T.init_params(0, cfg, device=CPU), cfg,
                                       {k: t(v) for k, v in b.items()})
        assert torch.isfinite(loss) and int(aux["n_tokens"]) > 0
    bad = dataclasses.replace(registry.get_config("llama32_1b", smoke=True),
                              block_pattern=("conv",))
    with pytest.raises(ValueError, match="conv"):
        T.init_params(0, bad, device=CPU)
    with pytest.raises(ValueError, match="conv"):
        T.init_caches(bad, 1, 16, device=CPU)
