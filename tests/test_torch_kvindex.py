"""The port's mqr-KV block selection (``repro_torch.core.kvindex``) held to
the JAX package's ``repro.core.kvindex`` on the CPU.

Selection and incremental state must be exactly equal; block MBRs and query
regions, which come from float32 dot products summed in whatever order each
library picks, within 1e-6 relative.  Reference state (KVIndex, IncKVIndex,
the group pyramid included) is carried across with ``repro_torch.convert``,
so selection is compared on identical inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bulk as ref_bulk
from repro.core import kvindex as ref_kv
from repro.kernels import ops as ref_ops
from repro_torch import convert
from repro_torch.core import bulk, kvindex
from repro_torch.kernels import ops

CPU = "cpu"


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype, order="C", copy=True))


def _keys(seed, s, d, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((s, d)) * scale).astype(np.float32)


def _probe(seed, d):
    return np.random.default_rng(seed + 1000).standard_normal(d).astype(np.float32)


def _ref_index(keys, probe, bs, levels):
    return ref_kv.build_kv_index(jnp.asarray(keys), jnp.asarray(probe), bs, levels)


def _regions(seed, n, kv_len, score_lo, score_hi):
    """Random regions over the (position, score) plane, some degenerate."""
    rng = np.random.default_rng(seed + 7)
    lo_p = rng.uniform(-10, kv_len, n)
    hi_p = lo_p + rng.uniform(0, kv_len, n)
    a = rng.uniform(score_lo, score_hi, n)
    b = a + rng.exponential((score_hi - score_lo) / 4, n)
    r = np.stack([lo_p, a, hi_p, b], axis=1).astype(np.float32)
    r[: n // 4, 3] = r[: n // 4, 1]  # zero-height bands: every area ties at 0
    return r


def test_pyramid_search_single_and_batched_regions_equal_reference():
    keys, probe = _keys(0, 2048, 32), _probe(0, 32)
    ref = _ref_index(keys, probe, 64, 6)
    port = convert.kvindex_from_numpy(ref._asdict(), device=CPU)
    regions = _regions(0, 24, 2048, -12.0, 12.0)
    batched = bulk.pyramid_search(port.pyramid, _t(regions))
    assert batched.shape == (24, 32)
    for i, r in enumerate(regions):
        want = np.asarray(ref_bulk.pyramid_search(ref.pyramid, jnp.asarray(r)))
        got = bulk.pyramid_search(port.pyramid, _t(r))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(batched[i].numpy(), want)


def test_pyramid_stats_equal_reference():
    keys, probe = _keys(1, 1024, 16), _probe(1, 16)
    ref = _ref_index(keys, probe, 32, 5)
    port = convert.kvindex_from_numpy(ref, device=CPU)
    assert bulk.pyramid_stats(port.pyramid) == ref_bulk.pyramid_stats(ref.pyramid)


@pytest.mark.parametrize("s,d,bs,levels", [(2048, 64, 128, 6), (1024, 32, 64, 5),
                                           (512, 16, 16, 4)])
def test_block_mbrs_and_pyramid_match_reference(s, d, bs, levels):
    keys, probe = _keys(s + d, s, d), _probe(s + d, d)
    want = np.asarray(ref_kv.block_mbrs(jnp.asarray(keys), jnp.asarray(probe), bs))
    got = kvindex.block_mbrs(_t(keys), _t(probe), bs)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    # built on identical block MBRs, the pyramid is identical
    ref_pyr = ref_bulk.build_pyramid(jnp.asarray(want), levels)
    pyr = bulk.build_pyramid(_t(want), levels)
    np.testing.assert_array_equal(pyr.group_of.numpy(), np.asarray(ref_pyr.group_of))
    np.testing.assert_array_equal(pyr.group_mbr.numpy(), np.asarray(ref_pyr.group_mbr))


def test_block_mbrs_of_bf16_keys_promote_like_the_reference():
    keys = _keys(5, 512, 32).astype(jnp.bfloat16)
    probe = _probe(5, 32)
    want = np.asarray(ref_kv.block_mbrs(jnp.asarray(keys), jnp.asarray(probe), 64))
    got = kvindex.block_mbrs(_t(keys.astype(np.float32)).to(torch.bfloat16),
                             _t(probe), 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("kv_len", [2048, np.int32(1500), "tensor"])
def test_query_region_matches_reference(kv_len):
    rng = np.random.default_rng(3)
    probe = _probe(3, 64)
    qs = rng.standard_normal((5, 64)).astype(np.float32)
    port_len = torch.tensor(777, dtype=torch.int32) if kv_len == "tensor" else kv_len
    ref_len = jnp.asarray(777, jnp.int32) if kv_len == "tensor" else kv_len
    batched = kvindex.query_region(_t(qs), _t(probe), port_len)
    assert batched.shape == (5, 4)
    for i, q in enumerate(qs):
        want = np.asarray(ref_kv.query_region(jnp.asarray(q), jnp.asarray(probe), ref_len))
        got = kvindex.query_region(_t(q), _t(probe), port_len)
        assert got.shape == (4,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
        np.testing.assert_allclose(batched[i].numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [1, 4, 8, 31])
def test_select_blocks_equal_reference(seed, k):
    keys, probe = _keys(seed, 4096, 32), _probe(seed, 32)
    ref = _ref_index(keys, probe, 128, 6)
    port = convert.kvindex_from_numpy(ref, device=CPU)
    regions = _regions(seed, 16, 4096, -8.0, 8.0)
    batched = kvindex.select_blocks_batched(port.block_mbr, port.pyramid, _t(regions), k)
    want_b = np.asarray(ref_kv.select_blocks_batched(ref.block_mbr, ref.pyramid,
                                                     jnp.asarray(regions), k))
    assert batched.dtype == torch.int32 and batched.shape == (16, k)
    np.testing.assert_array_equal(batched.numpy(), want_b)
    for i, r in enumerate(regions):
        want = np.asarray(ref_kv.select_blocks(ref, jnp.asarray(r), k))
        got = kvindex.select_blocks(port, _t(r), k)
        np.testing.assert_array_equal(got.numpy(), want)


def test_select_blocks_ties_follow_ascending_block_order():
    """Regions that no block overlaps: every score is 0.0 and the ids are the
    first k blocks; regions inside one block's score band tie at 1e6 + area
    in float32."""
    keys, probe = _keys(9, 2048, 16, scale=0.01), _probe(9, 16)
    ref = _ref_index(keys, probe, 64, 6)
    port = convert.kvindex_from_numpy(ref, device=CPU)
    regions = np.array([[5000, 50, 6000, 60],       # no overlap anywhere
                        [0, -1e-4, 2048, 1e-4],     # thin band through all blocks
                        [0, 0, 2048, 0],            # zero height
                        [100, -5, 100, 5],          # zero width
                        [0, -1e9, 4096, 1e9]],      # everything survives
                       np.float32)
    for r in regions:
        want = np.asarray(ref_kv.select_blocks(ref, jnp.asarray(r), 12))
        got = kvindex.select_blocks(port, _t(r), 12)
        np.testing.assert_array_equal(got.numpy(), want)
    got = kvindex.select_blocks(port, _t(regions[0]), 12)
    np.testing.assert_array_equal(got.numpy(), np.arange(12))


def test_select_blocks_rejects_k_out_of_range():
    keys, probe = _keys(4, 512, 8), _probe(4, 8)
    port = kvindex.build_kv_index(_t(keys), _t(probe), 64, 4)
    with pytest.raises(ValueError):
        kvindex.select_blocks(port, _t([0, 0, 512, 1]), 9)


@pytest.mark.parametrize("nb,bs,levels", [(16, 128, 6), (33, 32, 5)])
def test_incremental_index_equal_reference_step_by_step(nb, bs, levels):
    ref = ref_kv.init_incremental(nb, bs, levels)
    port = kvindex.init_incremental(nb, bs, levels, device=CPU)
    for got, want in zip(port, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the empty bound stays the finite 3.4e38
    assert torch.isfinite(port.block_mbr).all()
    rng = np.random.default_rng(nb)
    probe = _probe(nb, 16)
    regions = _regions(nb, 6, nb * bs, -4.0, 4.0)
    steps = rng.permutation(nb * bs)[:40].tolist() + list(range(0, nb * bs, bs // 2))
    for i, pos in enumerate(steps):
        score = np.float32(rng.standard_normal(16).astype(np.float32) @ probe)
        port_pos = torch.tensor(pos, dtype=torch.int32) if i % 2 else pos
        ref = ref_kv.incremental_update(ref, pos, score, bs)
        port = kvindex.incremental_update(port, port_pos, torch.tensor(score), bs)
        for got, want in zip(port, ref):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if i % 8 == 0:
            for k in (1, 5):
                want = np.stack([np.asarray(ref_kv.incremental_select(
                    ref, jnp.asarray(r), k)) for r in regions])
                np.testing.assert_array_equal(
                    kvindex.incremental_select(port, _t(regions), k).numpy(), want)
                np.testing.assert_array_equal(
                    kvindex.incremental_select(port, _t(regions[0]), k).numpy(), want[0])


def test_incremental_state_carried_across_selects_like_reference():
    ref = ref_kv.init_incremental(8, 16, 4)
    for pos in range(0, 128, 3):
        ref = ref_kv.incremental_update(ref, pos, np.float32(np.sin(pos)), 16)
    port = convert.inc_kvindex_from_numpy(ref._asdict(), device=CPU)
    region = np.array([0, -0.5, 100, 0.5], np.float32)
    want = np.asarray(ref_kv.incremental_select(ref, jnp.asarray(region), 6))
    np.testing.assert_array_equal(
        kvindex.incremental_select(port, _t(region), 6).numpy(), want)


def test_path_build_select_attend_matches_reference():
    """Keys on a small integer grid make every float32 dot product exact in
    any order: build -> select -> the plain kernel #9 gives the reference's
    ids, and an output within #9's float32 tolerance of the reference's
    Pallas kernel on those ids."""
    bh, nb, bs, d, k = 4, 16, 32, 16, 5
    rng = np.random.default_rng(11)
    keys = rng.integers(-3, 4, (bh, nb * bs, d)).astype(np.float32)
    vals = rng.standard_normal((bh, nb * bs, d)).astype(np.float32)
    probe = rng.integers(-2, 3, d).astype(np.float32)
    qs = rng.integers(-2, 3, (bh, d)).astype(np.float32)
    pos = nb * bs - 9
    ids_port, ids_ref = [], []
    for h in range(bh):
        ref = _ref_index(keys[h], probe, bs, 5)
        port = kvindex.build_kv_index(_t(keys[h]), _t(probe), bs, 5)
        np.testing.assert_array_equal(port.block_mbr.numpy(), np.asarray(ref.block_mbr))
        r_ref = ref_kv.query_region(jnp.asarray(qs[h]), jnp.asarray(probe), pos + 1)
        r_port = kvindex.query_region(_t(qs[h]), _t(probe), pos + 1)
        np.testing.assert_array_equal(r_port.numpy(), np.asarray(r_ref))
        ids_ref.append(np.asarray(ref_kv.select_blocks(ref, r_ref, k)))
        ids_port.append(kvindex.select_blocks(port, r_port, k))
    ids_ref = np.stack(ids_ref)
    ids = torch.stack(ids_port)
    np.testing.assert_array_equal(ids.numpy(), ids_ref)
    kb = keys.reshape(bh, nb, bs, d)
    vb = vals.reshape(bh, nb, bs, d)
    got = ops.mqr_sparse_attention(_t(qs), _t(kb), _t(vb), ids, pos)
    want = ref_ops.mqr_sparse_attention(jnp.asarray(qs), jnp.asarray(kb), jnp.asarray(vb),
                                        jnp.asarray(ids_ref), jnp.asarray(pos, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=2e-3)


def test_select_blocks_static_shape_and_in_range():
    """tests/test_kvindex.py's first check, on the port."""
    rng = np.random.default_rng(0)
    keys = _t(rng.standard_normal((2048, 64)).astype(np.float32))
    probe = _t(rng.standard_normal(64).astype(np.float32))
    q = _t(rng.standard_normal(64).astype(np.float32))
    idx = kvindex.build_kv_index(keys, probe, 128, 5)
    ids = kvindex.select_blocks(idx, kvindex.query_region(q, probe, 2048), 8)
    assert ids.shape == (8,) and ids.dtype == torch.int32
    assert int(ids.min()) >= 0 and int(ids.max()) < 16


def test_selected_blocks_cover_high_score_keys():
    """tests/test_kvindex.py's second check, on the port: the block holding
    the single highest q-aligned key must be selected."""
    key = jax.random.PRNGKey(3)
    keys = np.asarray(jax.random.normal(key, (1024, 32))) * 0.1
    probe = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (32,)))
    q = probe / np.linalg.norm(probe)
    keys[5 * 128 + 7] = 3.0 * q
    idx = kvindex.build_kv_index(_t(keys, np.float32), _t(probe, np.float32), 128, 5)
    region = kvindex.query_region(_t(q, np.float32), _t(probe, np.float32), 1024)
    ids = kvindex.select_blocks(idx, region, 4).numpy()
    assert 5 in ids, ids


# -- the batched build and selection (the counterpart of the reference's vmap)


def _grid_rows(seed, r, s, d):
    """Keys, probes and queries on small integer grids: every float32 dot
    product is exact in any order, so the port and the reference agree bit
    for bit."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-3, 4, (r, s, d)).astype(np.float32),
            rng.integers(-2, 3, (r, d)).astype(np.float32),
            rng.integers(-2, 3, (r, 3, d)).astype(np.float32))


def _same_index(got, want):
    np.testing.assert_array_equal(got.block_mbr.numpy(), np.asarray(want.block_mbr))
    np.testing.assert_array_equal(got.pyramid.group_of.numpy(), np.asarray(want.pyramid.group_of))
    np.testing.assert_array_equal(got.pyramid.group_mbr.numpy(),
                                  np.asarray(want.pyramid.group_mbr))


@pytest.mark.parametrize("r,s,d,bs,levels,k", [(6, 1024, 16, 64, 6, 5), (4, 512, 8, 32, 4, 16)])
def test_batched_build_and_select_equal_single_rows_and_reference_vmap(r, s, d, bs, levels, k):
    keys, probes, qs = _grid_rows(r + s, r, s, d)
    pos = s - 11
    batched = kvindex.build_kv_index(_t(keys), _t(probes), bs, levels)
    assert batched.block_mbr.shape == (r, s // bs, 4)
    assert batched.pyramid.group_of.shape == (r, levels, s // bs)
    regions = kvindex.query_region(_t(qs), _t(probes)[:, None, :], pos + 1)  # (R, G, 4)
    ids = kvindex.select_blocks(batched, regions, k)
    assert ids.shape == (r, 3, k) and ids.dtype == torch.int32
    # the reference's vmap over rows of build + (vmap over queries of) select
    @jax.jit
    def reference(keys, probes, qs):
        ref = jax.vmap(lambda kk, pp: ref_kv.build_kv_index(kk, pp, bs, levels))(keys, probes)
        ref_regions = jax.vmap(jax.vmap(
            lambda q, pp: ref_kv.query_region(q, pp, pos + 1), in_axes=(0, None)))(qs, probes)
        ref_ids = jax.vmap(lambda ix, rr: jax.vmap(
            lambda x: ref_kv.select_blocks(ix, x, k))(rr))(ref, ref_regions)
        return ref, ref_regions, ref_ids

    ref, ref_regions, ref_ids = reference(*map(jnp.asarray, (keys, probes, qs)))
    _same_index(batched, ref)
    np.testing.assert_array_equal(regions.numpy(), np.asarray(ref_regions))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    # and each row equals the single-row build and selection
    for i in range(r):
        single = kvindex.build_kv_index(_t(keys[i]), _t(probes[i]), bs, levels)
        np.testing.assert_array_equal(batched.block_mbr[i].numpy(), single.block_mbr.numpy())
        np.testing.assert_array_equal(batched.pyramid.group_of[i].numpy(),
                                      single.pyramid.group_of.numpy())
        np.testing.assert_array_equal(batched.pyramid.group_mbr[i].numpy(),
                                      single.pyramid.group_mbr.numpy())
        np.testing.assert_array_equal(ids[i].numpy(),
                                      kvindex.select_blocks(single, regions[i], k).numpy())
        np.testing.assert_array_equal(
            bulk.pyramid_search(batched.pyramid, regions)[i].numpy(),
            bulk.pyramid_search(single.pyramid, regions[i]).numpy())


def test_batched_build_of_float_keys_equals_single_rows_bit_for_bit():
    """Random bfloat16 keys and float32 probes (dot products that round):
    each row of the batched build equals its single-row build exactly,
    because the scores are summed in one fixed order whatever the batch."""
    rng = np.random.default_rng(21)
    keys = torch.from_numpy(rng.standard_normal((8, 2048, 64)).astype(np.float32))
    keys = keys.to(torch.bfloat16)
    probes = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32))
    qs = torch.from_numpy(rng.standard_normal((8, 4, 64)).astype(np.float32))
    batched = kvindex.build_kv_index(keys, probes, 128, 6)
    regions = kvindex.query_region(qs, probes[:, None, :], 2000)
    ids = kvindex.select_blocks(batched, regions, 5)
    for i in range(8):
        single = kvindex.build_kv_index(keys[i], probes[i], 128, 6)
        assert torch.equal(batched.block_mbr[i].view(torch.int32),
                           single.block_mbr.view(torch.int32))
        assert torch.equal(batched.pyramid.group_of[i], single.pyramid.group_of)
        assert torch.equal(batched.pyramid.group_mbr[i], single.pyramid.group_mbr)
        for g in range(4):
            assert torch.equal(regions[i, g], kvindex.query_region(qs[i, g], probes[i], 2000))
        assert torch.equal(ids[i], kvindex.select_blocks(single, regions[i], 5))


def test_batched_incremental_update_and_select_equal_single_rows_and_reference():
    """The incremental index over rows (R, ...): one update with a score a
    row, one selection of G regions a row, equal to each row alone and to
    the reference's vmap."""
    r, nb, bs, levels = 3, 8, 16, 4
    idx0 = kvindex.init_incremental(nb, bs, levels, device=CPU)
    rows = kvindex.IncKVIndex(*(a.expand(r, *a.shape).contiguous() for a in idx0))
    ref0 = ref_kv.init_incremental(nb, bs, levels)
    ref_rows = jax.tree.map(lambda a: jnp.broadcast_to(a, (r,) + a.shape), ref0)
    singles = [idx0] * r
    rng = np.random.default_rng(3)
    regions = _regions(3, r * 2, nb * bs, -3.0, 3.0).reshape(r, 2, 4)
    update = jax.jit(lambda ixs, pos, scs: jax.vmap(
        lambda ix, sc: ref_kv.incremental_update(ix, pos, sc, bs))(ixs, scs))
    for pos in rng.permutation(nb * bs)[:30].tolist():
        scores = rng.standard_normal(r).astype(np.float32)
        rows = kvindex.incremental_update(rows, pos, _t(scores), bs)
        ref_rows = update(ref_rows, pos, jnp.asarray(scores))
        singles = [kvindex.incremental_update(ix, pos, float(sc), bs)
                   for ix, sc in zip(singles, scores)]
    for got, want in zip(rows, ref_rows):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ids = kvindex.incremental_select(rows, _t(regions), 3)
    ref_ids = jax.vmap(lambda ix, rr: jax.vmap(
        lambda x: ref_kv.incremental_select(ix, x, 3))(rr))(ref_rows, jnp.asarray(regions))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    for i, single in enumerate(singles):
        for got, want in zip(single, rows):
            assert torch.equal(got, want[i])
        assert torch.equal(ids[i], kvindex.incremental_select(single, _t(regions[i]), 3))
