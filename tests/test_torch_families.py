"""The port's MoE FFN and its MLA, Mamba-2 and RG-LRU mixers
(``repro_torch.models.moe / mla / mamba2 / rglru``) held to the JAX
package's on the CPU, at the smoke size of ``scale_for_smoke``.

The same parameters go to both sides (the reference's, carried across as
tensors) and the same inputs from a numpy seed.  Tolerances:

- float32 within ``1e-5 + 1e-4 |jax|`` (``close32``), as
  ``tests/test_torch_models.py``;
- the SSD chunk sums and the RG-LRU scan, whose summation order differs
  from XLA's (a doubling scan against ``associative_scan``'s), within
  ``1e-4 + 1e-3 |jax|`` (``SCAN_ATOL``, ``SCAN_RTOL``);
- bfloat16 within the reference's own gates (0.25 decode against forward,
  0.05 sparse against dense, ``tests/test_decode_consistency.py``);
- MoE routing ids, gates' order and loads, and MLA's sparse block ids,
  exactly equal.
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
from repro.launch import serve as ref_serve
from repro.models import mamba2 as ref_m2
from repro.models import mla as ref_mla
from repro.models import moe as ref_moe
from repro.models import rglru as ref_rg
from repro.models import transformer as ref_T
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import serve as port_serve
from repro_torch.models import mamba2 as m2
from repro_torch.models import mla
from repro_torch.models import modules
from repro_torch.models import moe
from repro_torch.models import rglru as rg
from repro_torch.models import transformer as T

CPU = "cpu"
ATOL, RTOL = 1e-5, 1e-4
SCAN_ATOL, SCAN_RTOL = 1e-4, 1e-3
FAMILIES = ("granite_moe_1b", "deepseek_v3_671b", "mamba2_2p7b", "recurrentgemma_9b")


def close32(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().to(torch.float32).numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol, rtol=rtol)


def max_err(got, want) -> float:
    return float(np.max(np.abs(got.to(torch.float32).numpy() - np.asarray(want, np.float32))))


def t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def tt(tree):
    """A reference parameter dict (nested) as tensors."""
    if isinstance(tree, dict):
        return {k: tt(v) for k, v in tree.items()}
    return t(tree)


def cfg_pair(arch, **over):
    return (dataclasses.replace(ref_registry.get_config(arch, smoke=True), **over),
            dataclasses.replace(registry.get_config(arch, smoke=True), **over))


def normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# -- MoE ----------------------------------------------------------------------


def _moe_pair(router, dtype="float32", tie=True, seed=0):
    """granite-moe's smoke FFN (E 4, top-2) with the given router; the
    router's columns 1 and 2 made equal (and their bias), so their scores
    tie exactly; the sigmoid router gets a nonzero bias (selection only)."""
    over = dict(dtype=dtype, router_kind=router)
    if router == "sigmoid":
        over["n_shared_experts"] = 1
    ref_cfg, cfg = cfg_pair("granite_moe_1b", **over)
    p = ref_moe.init_moe(jax.random.PRNGKey(seed), ref_cfg, ref_cfg.d_model)
    p = jax.tree.map(np.asarray, p)
    if tie:
        p["router"] = p["router"].copy()
        p["router"][:, 2] = p["router"][:, 1]
    if router == "sigmoid":
        p["router_bias"] = np.array([0.05, -0.02, -0.02, 0.03], np.float32)
    return ref_cfg, cfg, jax.tree.map(jnp.asarray, p), tt(p)


def _ref_top(ref_p, ref_cfg, x):
    """The reference's routing ids and gates: moe_ffn's own lines."""
    logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32), ref_p["router"])
    if ref_cfg.router_kind == "sigmoid":
        scores = jax.nn.sigmoid(logits)
        sel = scores + ref_p["router_bias"][None, None, :]
    else:
        scores = jax.nn.softmax(logits, axis=-1)
        sel = scores
    _, idx = jax.lax.top_k(sel, ref_cfg.experts_per_tok)
    gate = jnp.take_along_axis(scores, idx, axis=-1)
    if ref_cfg.router_kind == "sigmoid":
        gate = gate / jnp.clip(gate.sum(-1, keepdims=True), 1e-9)
    return np.asarray(idx), np.asarray(gate)


@pytest.mark.parametrize("capacity_factor", [4.0, 0.5])
@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_moe_ffn_matches_reference(router, dispatch, capacity_factor):
    """Ids, gates, load and output of both routers and both dispatches,
    with a planted tie in the router scores; at factor 0.5 the capacity
    (8 slots of 32 tokens' 64 choices over 4 experts) drops choices."""
    ref_cfg, cfg, ref_p, p = _moe_pair(router)
    ref_cfg = dataclasses.replace(ref_cfg, moe_dispatch=dispatch)
    cfg = dataclasses.replace(cfg, moe_dispatch=dispatch)
    x = normal(1, (2, 32, 64))
    want_idx, want_gate = _ref_top(ref_p, ref_cfg, jnp.asarray(x))
    idx, gate = moe.route(p, cfg, t(x))
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    close32(gate, want_gate)
    # the tie decided a choice: expert 1 taken where 2, equal, was not
    tied = (want_idx == 1).any(-1) & ~(want_idx == 2).any(-1)
    assert tied.any()
    want, aux = ref_moe.moe_ffn(ref_p, ref_cfg, jnp.asarray(x), capacity_factor=capacity_factor)
    got, paux = moe.moe_ffn(p, cfg, t(x), capacity_factor=capacity_factor)
    np.testing.assert_array_equal(paux["expert_load"].numpy(), np.asarray(aux["expert_load"]))
    kept = float(paux["expert_load"].sum())
    if capacity_factor == 0.5:
        assert kept < cfg.experts_per_tok  # some choices dropped
    else:
        assert kept == cfg.experts_per_tok
    close32(got, want)


def test_moe_ffn_bf16_rounds_as_the_reference():
    """bfloat16 through both dispatches: ids and loads exactly equal, the
    output within the reference's own dispatch-parity gate (2e-2)."""
    for dispatch in ("einsum", "scatter"):
        ref_cfg, cfg, ref_p, p = _moe_pair("softmax", dtype="bfloat16")
        ref_cfg = dataclasses.replace(ref_cfg, moe_dispatch=dispatch)
        cfg = dataclasses.replace(cfg, moe_dispatch=dispatch)
        x = jnp.asarray(normal(2, (2, 32, 64)), jnp.bfloat16)
        want, aux = ref_moe.moe_ffn(ref_p, ref_cfg, x, capacity_factor=0.5)
        got, paux = moe.moe_ffn(p, cfg, t(x), capacity_factor=0.5)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(moe.route(p, cfg, t(x))[0].numpy(),
                                      _ref_top(ref_p, ref_cfg, x)[0])
        np.testing.assert_array_equal(paux["expert_load"].numpy(),
                                      np.asarray(aux["expert_load"]))
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=2e-2, rtol=2e-2)


def test_moe_queue_positions_follow_token_major_order():
    """The place in an expert's queue counts earlier tokens first, then
    earlier choices of the same token; the floor capacity."""
    top = torch.tensor([[[0, 1], [1, 0], [0, 2], [0, 1]]])  # (1, 4 tokens, k 2)
    slot, keep = moe.queue_slots(top, 3, capacity=2)
    np.testing.assert_array_equal(slot.numpy()[0], [[0, 0], [1, 1], [1, 0], [1, 1]])
    np.testing.assert_array_equal(keep.numpy()[0], [[1, 1], [1, 1], [0, 1], [0, 0]])
    cfg = registry.get_config("granite_moe_1b")
    assert moe.capacity_of(cfg, 1, 1.25) == 1          # int(0.3125) -> floor, then 1
    assert moe.capacity_of(cfg, 13, 1.25) == int(13 * 8 / 32 * 1.25) == 4


# -- MLA ----------------------------------------------------------------------


def _mla_pair(seed=3, **over):
    ref_cfg, cfg = cfg_pair("deepseek_v3_671b", dtype="float32", **over)
    p = ref_mla.init_mla(jax.random.PRNGKey(seed), ref_cfg, ref_cfg.d_model)
    return ref_cfg, cfg, p, tt(jax.tree.map(np.asarray, p))


@pytest.mark.parametrize("s,chunk", [(32, 8), (32, 32), (48, 16)])
def test_mla_train_matches_reference(s, chunk):
    ref_cfg, cfg, ref_p, p = _mla_pair()
    x = normal(s, (2, s, 64))
    pos = np.broadcast_to(np.arange(s), (2, s)).astype(np.int32)
    want = ref_mla.mla_train(ref_p, ref_cfg, jnp.asarray(x), jnp.asarray(pos), chunk=chunk)
    got = mla.mla_train(p, cfg, t(x), t(pos), chunk=chunk)
    assert got.shape == (2, s, 64)
    close32(got, want)


def _latent_cache(ref_cfg, b, s, upto, seed):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((b, s, ref_cfg.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((b, s, ref_cfg.qk_rope_head_dim)).astype(np.float32)
    c[:, upto:], kr[:, upto:] = 0, 0
    return ({"c_kv": jnp.asarray(c), "k_rope": jnp.asarray(kr)},
            {"c_kv": t(c), "k_rope": t(kr)})


@pytest.mark.parametrize("mode", ["dense", "sparse", "sparse_all"])
def test_mla_decode_matches_reference(mode):
    """Dense decode over the whole latent cache, and the mqr-KV sparse
    decode with top-K 4 of 8 blocks (pruning) and of 4 (every block), at
    several positions; the cache written in place equals the reference's."""
    s = 128 if mode == "sparse" else 64
    ref_cfg, cfg, ref_p, p = _mla_pair(mqr_block=16, mqr_topk=4)
    x = normal(4, (2, 1, 64))
    decode = jax.jit(lambda pp, xx, cc, pos: ref_mla.mla_decode(
        pp, ref_cfg, xx, cc, pos, mqr_sparse=mode != "dense"))
    for pos in (s - 37, s - 1, 17):
        ref_c, c = _latent_cache(ref_cfg, 2, s, pos, seed=pos)
        want, ref_c = decode(ref_p, jnp.asarray(x), ref_c, pos)
        got, c = mla.mla_decode(p, cfg, t(x), c, pos, mqr_sparse=mode != "dense")
        close32(got, want)
        close32(c["c_kv"], ref_c["c_kv"])
        close32(c["k_rope"], ref_c["k_rope"])


def test_mla_sparse_block_ids_equal_reference_selection():
    """One index per batch row over the latent, each head's region from its
    absorbed query: ids equal the reference's per-row build and per-head
    select (values on a small integer grid, so every dot product is
    exact)."""
    ref_cfg, cfg = cfg_pair("deepseek_v3_671b", dtype="float32", mqr_block=16, mqr_topk=3)
    rng = np.random.default_rng(6)
    b, s, h, rank = 2, 128, 4, ref_cfg.kv_lora_rank
    c = rng.integers(-3, 4, (b, s, rank)).astype(np.float32)
    probe = rng.integers(-2, 3, (rank,)).astype(np.float32)
    q_eff = rng.integers(-2, 3, (b, h, rank)).astype(np.float32)
    pos = s - 20
    got = mla.sparse_block_ids({"probe": t(probe)}, cfg, t(q_eff), t(c), pos)
    want = []
    for bi in range(b):
        ix = ref_kv.build_kv_index(jnp.asarray(c[bi]), jnp.asarray(probe), 16,
                                   ref_cfg.mqr_levels)
        want.append([np.asarray(ref_kv.select_blocks(
            ix, ref_kv.query_region(jnp.asarray(q_eff[bi, hi]), jnp.asarray(probe), pos + 1), 3))
            for hi in range(h)])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- Mamba-2 ------------------------------------------------------------------


def _m2_pair(seed=5, **over):
    ref_cfg, cfg = cfg_pair("mamba2_2p7b", dtype="float32", **over)
    p = ref_m2.init_mamba2(jax.random.PRNGKey(seed), ref_cfg, ref_cfg.d_model)
    p = jax.tree.map(np.asarray, p)
    p["dt_bias"] = normal(9, p["dt_bias"].shape, 0.5)  # heads decaying at different rates
    p["conv_b"] = normal(10, p["conv_b"].shape, 0.1)
    return ref_cfg, cfg, jax.tree.map(jnp.asarray, p), tt(p)


@pytest.mark.parametrize("s,chunk", [(32, 8), (32, 32), (64, 16)])
def test_mamba2_train_matches_reference(s, chunk):
    """The chunked SSD within the scan tolerance (its chunk sums are ordered
    otherwise than XLA's)."""
    ref_cfg, cfg, ref_p, p = _m2_pair()
    x = normal(s + 1, (2, s, 64))
    want = ref_m2.mamba2_train(ref_p, ref_cfg, jnp.asarray(x), chunk=chunk)
    got = m2.mamba2_train(p, cfg, t(x), chunk=chunk)
    assert got.shape == x.shape
    close32(got, want, SCAN_ATOL, SCAN_RTOL)


def test_mamba2_decode_matches_reference_and_its_prefill():
    """20 tokens through the recurrent decode: outputs and caches (the conv
    window, the float32 state) equal the reference's; the outputs equal the
    port's own chunked prefill of the same tokens."""
    ref_cfg, cfg, ref_p, p = _m2_pair()
    b, s = 2, 20
    ref_c = ref_m2.init_mamba2_cache(ref_cfg, b, ref_cfg.d_model, jnp.float32)
    c = m2.init_mamba2_cache(cfg, b, cfg.d_model, torch.float32, CPU)
    xs = normal(11, (b, s, 64))
    decode = jax.jit(lambda pp, xx, cc: ref_m2.mamba2_decode(pp, ref_cfg, xx, cc))
    outs = []
    for i in range(s):
        want, ref_c = decode(ref_p, jnp.asarray(xs[:, i:i + 1]), ref_c)
        got, c = m2.mamba2_decode(p, cfg, t(xs[:, i:i + 1]), c)
        close32(got, want)
        outs.append(got)
    close32(c["conv"], ref_c["conv"])
    close32(c["ssm"], ref_c["ssm"])
    full = m2.mamba2_train(p, cfg, t(xs), chunk=4)
    close32(torch.cat(outs, dim=1), full.numpy(), SCAN_ATOL, SCAN_RTOL)


# -- RG-LRU -------------------------------------------------------------------


def _rg_pair(seed=7):
    ref_cfg, cfg = cfg_pair("recurrentgemma_9b", dtype="float32")
    p = ref_rg.init_rglru(jax.random.PRNGKey(seed), ref_cfg, ref_cfg.d_model)
    p = jax.tree.map(np.asarray, p)
    p["lam"] = normal(12, p["lam"].shape, 1.0)  # a spread of decay rates
    p["b_a"] = normal(13, p["b_a"].shape, 0.5)
    return ref_cfg, cfg, jax.tree.map(jnp.asarray, p), tt(p)


@pytest.mark.parametrize("s", [1, 37, 64])
def test_rglru_train_matches_reference(s):
    """The doubling scan against ``associative_scan``, within the scan
    tolerance; S 37 is not a power of two."""
    ref_cfg, cfg, ref_p, p = _rg_pair()
    x = normal(s + 2, (2, s, 64))
    want = ref_rg.rglru_train(ref_p, ref_cfg, jnp.asarray(x))
    got = rg.rglru_train(p, cfg, t(x))
    close32(got, want, SCAN_ATOL, SCAN_RTOL)


def test_linear_scan_equals_the_recurrence():
    rng = np.random.default_rng(14)
    a = rng.uniform(0.2, 1.0, (3, 45, 5))
    b = rng.standard_normal((3, 45, 5))
    h, want = np.zeros((3, 5)), []
    for i in range(45):
        h = a[:, i] * h + b[:, i]
        want.append(h)
    got = rg.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.stack(want, axis=1), rtol=1e-12, atol=1e-12)


def test_rglru_decode_matches_reference_and_its_prefill():
    ref_cfg, cfg, ref_p, p = _rg_pair()
    b, s = 2, 20
    ref_c = ref_rg.init_rglru_cache(ref_cfg, b, jnp.float32)
    c = rg.init_rglru_cache(cfg, b, torch.float32, CPU)
    xs = normal(15, (b, s, 64))
    decode = jax.jit(lambda pp, xx, cc: ref_rg.rglru_decode(pp, ref_cfg, xx, cc))
    outs = []
    for i in range(s):
        want, ref_c = decode(ref_p, jnp.asarray(xs[:, i:i + 1]), ref_c)
        got, c = rg.rglru_decode(p, cfg, t(xs[:, i:i + 1]), c)
        close32(got, want)
        outs.append(got)
    close32(c["conv"], ref_c["conv"])
    close32(c["h"], ref_c["h"])
    close32(torch.cat(outs, dim=1), rg.rglru_train(p, cfg, t(xs)).numpy(),
            SCAN_ATOL, SCAN_RTOL)


# -- the model: parameters, bf16 gates, serve ---------------------------------


@functools.lru_cache(maxsize=None)
def ref_params(ref_cfg, seed=0):
    return jax.jit(lambda key: ref_T.init_params(key, ref_cfg))(jax.random.PRNGKey(seed))


def test_params_from_numpy_round_trips_blocks_dense_and_mtp():
    """DeepSeek's smoke config: the dense stack, the MoE stack and the MTP
    depth unstacked leaf for leaf; a wrong depth count raises."""
    ref_cfg, cfg = cfg_pair("deepseek_v3_671b", dtype="float32", mtp_depth=2)
    ref_p = jax.tree.map(np.asarray, ref_params(ref_cfg))
    p = convert.params_from_numpy(ref_p, cfg, device=CPU)
    assert set(p) == set(ref_p) >= {"blocks_dense", "blocks", "mtp"}
    assert (len(p["blocks_dense"]), len(p["blocks"]), len(p["mtp"])) == (1, 2, 2)
    for key in ("blocks_dense", "blocks", "mtp"):
        leaves = jax.tree_util.tree_leaves_with_path(ref_p[key])
        for i, entry in enumerate(p[key]):
            assert len(modules.tree_leaves(entry)) == len(leaves)
            for path, want in leaves:
                got = entry
                for k in path:
                    got = got[k.key]
                np.testing.assert_array_equal(got.numpy(), want[i], err_msg=f"{key}{path}")
    bad = dict(ref_p, mtp=jax.tree.map(lambda a: a[:1], ref_p["mtp"]))
    with pytest.raises(ValueError, match="params/mtp: every leaf must stack 2 depths"):
        convert.params_from_numpy(bad, cfg, device=CPU)
    bad = dict(ref_p, blocks_dense=jax.tree.map(lambda a: a[:0], ref_p["blocks_dense"]))
    with pytest.raises(ValueError, match="params/blocks_dense"):
        convert.params_from_numpy(bad, cfg, device=CPU)


def test_empty_moe_stack_runs_as_the_reference():
    """DeepSeek cut to its one dense layer: an empty MoE stack, as the
    reference takes it (the float32 copy chip_smoke.py checks MLA on)."""
    ref_cfg, cfg = cfg_pair("deepseek_v3_671b", dtype="float32", n_layers=1, n_dense_layers=1,
                            mtp_depth=0)
    ref_p = ref_params(ref_cfg)
    p = convert.params_from_numpy(jax.tree.map(np.asarray, ref_p), cfg, device=CPU)
    assert len(p["blocks"]) == 0 and len(T.init_caches(cfg, 1, 16, device=CPU)["moe"]) == 0
    toks = np.random.default_rng(16).integers(0, 256, (2, 16)).astype(np.int32)
    want = ref_T.prefill(ref_p, ref_cfg, {"tokens": jnp.asarray(toks)})
    close32(T.prefill(p, cfg, {"tokens": t(toks)}), want)


# A token whose k-th and (k+1)-th selection scores lie closer than this in
# some MoE layer may route differently under one bfloat16 ulp of noise in
# its hidden state (the scores move by ~1e-3): a discrete flip, not a
# rounding error, which moves that token's logits by up to ~0.5.
NEAR_TIE = 1e-2


def _bf16_pair(arch, s, sparse, monkeypatch):
    """Teacher-forced bfloat16 decode of the reference's own gate tokens
    (``tests/test_decode_consistency.py``) through both packages, and the
    port's forward; near-tied tokens (NEAR_TIE) of the port's MoE layers
    are marked."""
    ref_cfg, cfg = cfg_pair(arch)
    ref_p = ref_params(ref_cfg)
    p = convert.params_from_numpy(jax.tree.map(np.asarray, ref_p), cfg, device=CPU)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (1, s), 0, cfg.vocab_size,
                                         jnp.int32))
    near = np.zeros(s, bool)
    route = moe.route

    def recording(params, c, x):
        out = route(params, c, x)
        logits = x.to(torch.float32) @ params["router"]
        sel = (torch.sigmoid(logits) + params["router_bias"] if c.router_kind == "sigmoid"
               else torch.softmax(logits, -1))
        top = torch.sort(sel, -1, descending=True).values
        margin = (top[..., c.experts_per_tok - 1] - top[..., c.experts_per_tok])[0].numpy()
        if len(margin) == s:  # the forward: every token at once
            near[:] |= margin < NEAR_TIE
        return out

    monkeypatch.setattr(moe, "route", recording)
    step = jax.jit(lambda pp, tk, c, pos: ref_T.decode_step(pp, ref_cfg, tk, c, pos,
                                                            mqr_sparse=sparse))
    ref_c, c = ref_T.init_caches(ref_cfg, 1, s), T.init_caches(cfg, 1, s, device=CPU)
    ref_out, out = [], []
    for i in range(s):
        lg, ref_c = step(ref_p, jnp.asarray(toks[:, i:i + 1]), ref_c, i)
        ref_out.append(np.asarray(lg, np.float32))
        out.append(T.decode_step(p, cfg, t(toks[:, i:i + 1]), c, i, mqr_sparse=sparse)[0])
    x, pos, _ = T.embed_inputs(p, cfg, {"tokens": t(toks)})
    full = T.logits_fn(p, cfg, T.forward_hidden(p, cfg, x, pos)[0])
    return torch.cat(out, 1), np.concatenate(ref_out, 1), full, near


@pytest.mark.parametrize("arch", FAMILIES)
def test_bf16_decode_within_the_reference_gates(arch, monkeypatch):
    """bfloat16 at the smoke size: the port's decode against its forward
    and against the reference's decode within 0.25; where the family has
    attention over a cache, the sparse decode with top-K = every block
    against dense within 0.05.  MoE tokens at a routing near-tie (NEAR_TIE,
    at most a quarter of them) are left out of the 0.25 gate."""
    s = 32
    dense, ref_dense, full, near = _bf16_pair(arch, s, False, monkeypatch)
    assert near.mean() <= 0.25
    keep = ~near
    assert max_err(dense[:, keep], full.float().numpy()[:, keep]) < 0.25
    assert max_err(dense[:, keep], ref_dense[:, keep]) < 0.25
    if arch in ("granite_moe_1b", "deepseek_v3_671b"):
        cfg = registry.get_config(arch, smoke=True)
        assert cfg.mqr_topk * cfg.mqr_block >= s  # top-K covers every block
        sparse, ref_sparse, *_ = _bf16_pair(arch, s, True, monkeypatch)
        assert max_err(sparse[:, -1:], dense[:, -1:].float().numpy()) < 0.05
        assert max_err(sparse[:, -1:], ref_sparse[:, -1:]) < 0.05


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_equals_reference_tokens(monkeypatch, arch):
    """``serve`` of both packages on the float32 smoke config (both
    registries patched), the same parameters and prompts: the same greedy
    tokens, dense (and mqr-sparse where the family attends over a cache)."""
    def f32(get):
        return lambda a, smoke=False: dataclasses.replace(get(a, smoke), dtype="float32")

    monkeypatch.setattr(ref_registry, "get_config", f32(ref_registry.get_config))
    monkeypatch.setattr(registry, "get_config", f32(registry.get_config))
    ref_cfg = ref_registry.get_config(arch, True)
    ref_p = ref_params(ref_cfg)
    p = convert.params_from_numpy(jax.tree.map(np.asarray, ref_p), registry.get_config(arch, True),
                                  device=CPU)
    prompts = np.random.default_rng(18).integers(0, 256, (2, 12)).astype(np.int32)
    for sparse in (False, True) if arch in ("granite_moe_1b", "deepseek_v3_671b") else (False,):
        kw = dict(arch=arch, smoke=True, batch=2, prompt_len=12, gen=6, mqr_sparse=sparse)
        want = ref_serve.serve(params=ref_p, prompts=jnp.asarray(prompts), **kw)
        got = port_serve.serve(params=p, prompts=prompts, device=CPU, **kw)
        np.testing.assert_array_equal(got, want)


# -- init ---------------------------------------------------------------------


def test_trunc_normal_draws_small_tensors_whole_and_large_ones_in_slices(monkeypatch):
    """Below SLICE_ELEMENTS a tensor is one whole draw, bit for bit the
    rule before slicing existed (so llama3.2-1B's random init, whose every
    tensor lies below it, is unchanged); above it, slices of the leading
    axis are drawn in turn with the same rule."""
    def whole(shape, std, dtype, seed):
        g = torch.Generator().manual_seed(seed)
        w = torch.empty(shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g)
        return (w * std).to(dtype)

    got = modules.trunc_normal((64, 33), 0.1, torch.bfloat16, torch.Generator().manual_seed(3))
    assert torch.equal(got, whole((64, 33), 0.1, torch.bfloat16, 3))
    big = T._init_params(torch.device("meta"), registry.get_config("llama32_1b"))
    for leaf in modules.tree_leaves(big):
        assert leaf.numel() <= modules.SLICE_ELEMENTS
    monkeypatch.setattr(modules, "SLICE_ELEMENTS", 1000)
    sliced = modules.trunc_normal((10, 7, 33), 0.5, torch.float32,
                                  torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(4)
    want = torch.cat([modules._draw((4, 7, 33), 0.5, torch.float32, g),
                      modules._draw((4, 7, 33), 0.5, torch.float32, g),
                      modules._draw((2, 7, 33), 0.5, torch.float32, g)])
    assert torch.equal(sliced, want) and float(sliced.abs().max()) <= 1.0
    meta = modules.trunc_normal((10, 7, 33), 0.5, torch.bfloat16, torch.device("meta"))
    assert meta.shape == (10, 7, 33) and meta.dtype == torch.bfloat16
