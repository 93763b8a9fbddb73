"""Kernels #8-#10 of the port (flash attention, mqr sparse decode attention,
RMSNorm) held to the JAX package on the CPU.

Each plain version (what the port's wrapper runs for a CPU tensor) is held
against the reference's Pallas kernel in interpret mode and against its
``ref.py`` oracle, reached through ``repro.kernels.ops``, at the shapes and
with the tolerances of ``tests/test_kernels.py``: these are floating
reductions, summed in another order in each library, so the reference's own
tolerance is the bar.  Inputs are made from a numpy seed; bfloat16 inputs
are the same rounded values on both sides.  On the card the CUDA kernels
are held to these plain versions by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.models.attention import flash_attention_jnp
from repro_torch.kernels import flash_attention, mqr_sparse_attention, ops

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FLASH_TOL = {"float32": 2e-3, "bfloat16": 2e-2}
SPARSE_TOL = {"float32": 2e-3, "bfloat16": 3e-2}
NORM_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
AGAINST = ("pallas", "ref")


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(a, dtype):
    """The same values as a JAX array and a CPU tensor of ``dtype``."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.ascontiguousarray(a)).to(td)


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# -- #8 flash attention ------------------------------------------------------


@pytest.mark.parametrize("against", AGAINST)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bh,s,d", [(2, 128, 64), (4, 256, 128), (1, 384, 128), (2, 256, 256)])
def test_flash_attention_sweep(against, dtype, bh, s, d):
    seed = bh * s + d
    (jq, tq), (jk, tk), (jv, tv) = (_both(_normal(seed + i, (bh, s, d)), dtype)
                                    for i in range(3))
    got = ops.flash_attention(tq, tk, tv, block_q=128, block_k=128)
    assert got.dtype == tq.dtype and got.shape == (bh, s, d)
    want = (ref_ops.flash_attention(jq, jk, jv, block_q=128, block_k=128)
            if against == "pallas" else ref_ops.flash_attention_ref(jq, jk, jv))
    _close(got, want, FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bh,s,d,block", [(3, 320, 64, 64), (2, 200, 64, 8), (2, 64, 64, 64)])
def test_flash_attention_s_off_the_card_kernels_tiles(dtype, bh, s, d, block):
    """S that is no multiple of the card kernels' query tiles (128 to 256
    rows) but is one of block_q and block_k: the wrapper admits it."""
    seed = bh * s + d + block
    (jq, tq), (jk, tk), (jv, tv) = (_both(_normal(seed + i, (bh, s, d)), dtype)
                                    for i in range(3))
    got = ops.flash_attention(tq, tk, tv, block_q=block, block_k=block)
    assert got.dtype == tq.dtype and got.shape == (bh, s, d)
    _close(got, ref_ops.flash_attention_ref(jq, jk, jv), FLASH_TOL[dtype])


def test_flash_attention_rejects_s_not_divisible_by_the_blocks():
    q = torch.zeros((1, 192, 64))
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, q, q, block_q=64, block_k=128)
    assert ops.flash_attention(q, q, q, block_q=64, block_k=64).shape == q.shape


def test_flash_attention_rejects_mixed_or_unsupported_dtypes():
    q = torch.zeros((1, 128, 64))
    with pytest.raises(TypeError):
        ops.flash_attention(q, q.to(torch.bfloat16), q)
    with pytest.raises(TypeError):
        ops.flash_attention(q.to(torch.float16), q, q)


@pytest.mark.parametrize("d,ok", [(64, True), (128, True), (256, True), (32, False),
                                  (96, False), (512, False)])
def test_flash_attention_head_dims_of_the_card_kernel(d, ok):
    """The card's kernel is built for D 64, 128 and 256 (gemma-2b's head
    dim); any other raises ``ValueError`` before a launch."""
    assert (d in flash_attention.HEAD_DIMS) == ok
    if ok:
        flash_attention.check_head_dim(d)
    else:
        with pytest.raises(ValueError, match="built for D"):
            flash_attention.check_head_dim(d)


def test_flash_matches_model_attention_path():
    """The port's flash attention and the reference model's portable flash
    path agree (``tests/test_kernels.py``'s check, on the port)."""
    b, s, h, dh = 2, 256, 4, 64
    q, k, v = (_normal(i, (b, s, h, dh)) for i in range(3))
    positions = jnp.broadcast_to(jnp.arange(s), (b, s))
    want = flash_attention_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               positions, positions, chunk=128)

    def heads(x):
        return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, 2, 1))).reshape(
            b * h, s, dh)

    got = ops.flash_attention(heads(q), heads(k), heads(v)).reshape(b, h, s, dh)
    np.testing.assert_allclose(got.movedim(1, 2).numpy(), np.asarray(want),
                               atol=2e-3, rtol=2e-3)


# -- #9 mqr sparse decode attention -----------------------------------------


def _sparse_inputs(dtype, bh, nb, bs, d, ids):
    seed = nb * bs + d
    (jk, tk), (jv, tv) = (_both(_normal(seed + i, (bh, nb, bs, d)), dtype) for i in (0, 1))
    jq, tq = _both(_normal(seed + 2, (bh, d)), dtype)
    ids = np.asarray(ids, np.int32)
    return (jq, jk, jv, jnp.asarray(ids)), (tq, tk, tv, torch.from_numpy(ids))


def _sparse_check(against, dtype, jargs, targs, pos, tol=None):
    got = ops.mqr_sparse_attention(*targs, pos)
    assert got.dtype == targs[0].dtype and got.shape == targs[0].shape
    fn = ref_ops.mqr_sparse_attention if against == "pallas" else ref_ops.mqr_sparse_attention_ref
    want = fn(*jargs, jnp.asarray(pos, jnp.int32))
    _close(got, want, tol or SPARSE_TOL[dtype])
    # pos given as a 0-d tensor instead of an int: the same answer
    torch.testing.assert_close(ops.mqr_sparse_attention(*targs, torch.tensor(pos)), got,
                               rtol=0, atol=0)


@pytest.mark.parametrize("against", AGAINST)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bh,nb,bs,d,k", [(2, 8, 128, 64, 3), (4, 16, 128, 128, 8)])
def test_mqr_sparse_attention_sweep(against, dtype, bh, nb, bs, d, k):
    rng = np.random.default_rng(nb * bs + d + 3)
    ids = np.stack([rng.permutation(nb)[:k] for _ in range(bh)])
    jargs, targs = _sparse_inputs(dtype, bh, nb, bs, d, ids)
    _sparse_check(against, dtype, jargs, targs, nb * bs // 2)


@pytest.mark.parametrize("against", AGAINST)
@pytest.mark.parametrize("dtype", DTYPES)
def test_mqr_sparse_attention_repeated_ids_attend_twice(against, dtype):
    """``select_blocks`` pads with repeats when fewer than K blocks survive;
    a repeated block counts once per appearance."""
    ids = [[3, 3, 1, 3], [0, 5, 5, 2]]
    jargs, targs = _sparse_inputs(dtype, 2, 8, 128, 64, ids)
    _sparse_check(against, dtype, jargs, targs, 8 * 128 - 40)
    once = ops.mqr_sparse_attention(targs[0], targs[1], targs[2],
                                    torch.tensor([[3, 1, 1, 1], [0, 5, 2, 2]], dtype=torch.int32),
                                    8 * 128 - 40)
    assert not torch.equal(once, ops.mqr_sparse_attention(*targs, 8 * 128 - 40))


@pytest.mark.parametrize("against", AGAINST)
@pytest.mark.parametrize("dtype", DTYPES)
def test_mqr_sparse_attention_first_block_past_pos(against, dtype):
    """The first block walked lies wholly past ``pos``: its keys weigh in
    with exp(0) until a later block wipes them (-1e30, not -inf: no NaN)."""
    ids = [[7, 2, 0], [6, 7, 1]]
    jargs, targs = _sparse_inputs(dtype, 2, 8, 128, 64, ids)
    _sparse_check(against, dtype, jargs, targs, 3 * 128 + 5)
    assert torch.isfinite(ops.mqr_sparse_attention(*targs, 3 * 128 + 5).float()).all()


@pytest.mark.parametrize("against", AGAINST)
@pytest.mark.parametrize("dtype", DTYPES)
def test_mqr_sparse_attention_every_key_masked(against, dtype):
    """All selected keys past ``pos``: a uniform average, as the reference."""
    ids = [[5, 6], [7, 4]]
    jargs, targs = _sparse_inputs(dtype, 2, 8, 128, 64, ids)
    _sparse_check(against, dtype, jargs, targs, 3 * 128)
    got = ops.mqr_sparse_attention(*targs, 3 * 128).float()
    vg = targs[2][torch.arange(2)[:, None], torch.tensor(ids)].float()
    _close(got, vg.reshape(2, -1, 64).mean(dim=1), SPARSE_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_mqr_sparse_attention_out_of_range_ids_clamp_like_the_oracle(dtype):
    """An id outside [0, nb) reads the block ``ref.py``'s jnp gather reads
    (negative ids count from the end, then the index clamps) and is masked by
    its own position (the Pallas kernel has no defined behaviour there)."""
    ids = [[9, 0, -2], [1, 40, -100]]
    jargs, targs = _sparse_inputs(dtype, 2, 8, 128, 64, ids)
    _sparse_check("ref", dtype, jargs, targs, 8 * 128 + 100)
    _sparse_check("ref", dtype, jargs, targs, 5 * 128)


def test_mqr_sparse_attention_checks_arguments():
    q, kb = torch.zeros((2, 64)), torch.zeros((2, 8, 128, 64))
    ids = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.mqr_sparse_attention(q, kb, kb, ids.long(), 10)
    with pytest.raises(ValueError):
        ops.mqr_sparse_attention(q, kb, kb, ids[:1], 10)
    with pytest.raises(ValueError):
        ops.mqr_sparse_attention(q, kb, kb, ids, torch.tensor([1.5]))
    with pytest.raises(ValueError):
        ops.mqr_sparse_attention(q[:, :32], kb, kb, ids, 10)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("group,pos", [(2, 8 * 128 - 40), (4, 3 * 128 + 5), (8, 5 * 128)])
def test_mqr_sparse_attention_group_reads_kv_row_r_over_group(dtype, group, pos):
    """With ``group`` > 1 query row r reads kv row r // group in place: the
    answer equals the ``group=1`` call on the kv rows repeated ``group``
    times, bit for bit, and the Pallas kernel on the repeated rows within
    its tolerance."""
    bh_kv, nb, bs, d, k = 2, 8, 128, 64, 3
    bh = bh_kv * group
    rng = np.random.default_rng(group)
    ids = np.stack([rng.permutation(nb)[:k] for _ in range(bh)]).astype(np.int32)
    (jk, tk), (jv, tv) = (_both(_normal(group + i, (bh_kv, nb, bs, d)), dtype) for i in (0, 1))
    jq, tq = _both(_normal(group + 2, (bh, d)), dtype)
    tids = torch.from_numpy(ids)
    got = ops.mqr_sparse_attention(tq, tk, tv, tids, pos, group=group)
    assert got.dtype == tq.dtype and got.shape == (bh, d)
    rep_k, rep_v = (t.repeat_interleave(group, 0) for t in (tk, tv))
    torch.testing.assert_close(got, ops.mqr_sparse_attention(tq, rep_k, rep_v, tids, pos),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        ops.mqr_sparse_attention_torch(tq, tk, tv, tids, torch.tensor(pos), group), got,
        rtol=0, atol=0)
    want = ref_ops.mqr_sparse_attention(jq, jnp.repeat(jk, group, 0), jnp.repeat(jv, group, 0),
                                        jnp.asarray(ids), jnp.asarray(pos, jnp.int32))
    _close(got, want, SPARSE_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("group,d", [(8, 256), (2, 128)])
def test_mqr_sparse_attention_group_at_model_head_dims(dtype, group, d):
    """gemma-2b's shape (group 8, head dim 256) and internvl2's (group 2,
    head dim 128): the plain version reading kv row r // group, with
    repeated and shared ids, against the Pallas kernel in interpret mode on
    the kv rows repeated ``group`` times."""
    bh_kv, nb, bs, k = 2, 8, 128, 4
    bh = bh_kv * group
    rng = np.random.default_rng(group * d)
    ids = np.stack([rng.permutation(nb)[:k] for _ in range(bh)]).astype(np.int32)
    ids[group - 1] = ids[0]  # two heads of a group with the same ids
    ids[1, 1] = ids[1, 0]  # a block selected twice by one head
    pos = 5 * bs + 17
    (jk, tk), (jv, tv) = (_both(_normal(d + i, (bh_kv, nb, bs, d)), dtype) for i in (0, 1))
    jq, tq = _both(_normal(d + 2, (bh, d)), dtype)
    got = ops.mqr_sparse_attention(tq, tk, tv, torch.from_numpy(ids), pos, group=group)
    assert got.dtype == tq.dtype and got.shape == (bh, d)
    want = ref_ops.mqr_sparse_attention(jq, jnp.repeat(jk, group, 0), jnp.repeat(jv, group, 0),
                                        jnp.asarray(ids), jnp.asarray(pos, jnp.int32))
    _close(got, want, SPARSE_TOL[dtype])


@pytest.mark.parametrize("dtype,d,nb,ok", [
    ("bfloat16", 64, 256, True), ("bfloat16", 256, 256, True), ("bfloat16", 8, 1, True),
    ("float32", 4, 65_536, True), ("float32", 256, 256, True), ("bfloat16", 264, 256, False),
    ("bfloat16", 12, 256, False), ("float32", 6, 256, False), ("float32", 512, 256, False),
    ("bfloat16", 0, 256, False), ("bfloat16", 64, 65_537, False)])
def test_mqr_sparse_attention_shapes_of_the_card_kernel(dtype, d, nb, ok):
    """The card's kernel takes D a multiple of 16 bytes' worth of elements up
    to 256 and at most 65,536 blocks a kv row; any other shape raises
    ``ValueError`` before a launch (the CPU's plain version takes any)."""
    td = DTYPES[dtype][1]
    if ok:
        mqr_sparse_attention.check_kernel_shape(d, nb, td)
    else:
        with pytest.raises(ValueError, match="the kernel takes"):
            mqr_sparse_attention.check_kernel_shape(d, nb, td)
    if d:
        q = torch.zeros((2, d), dtype=td)
        kb = torch.zeros((2, 1, 4, d), dtype=td)
        ids = torch.zeros((2, 1), dtype=torch.int32)
        assert ops.mqr_sparse_attention(q, kb, kb, ids, 3).shape == (2, d)


def test_mqr_sparse_attention_checks_group():
    q, kb = torch.zeros((8, 64)), torch.zeros((2, 8, 128, 64))
    ids = torch.zeros((8, 3), dtype=torch.int32)
    assert ops.mqr_sparse_attention(q, kb, kb, ids, 10, group=4).shape == (8, 64)
    for bad in (0, 3, 2, 2.0):  # not a positive int dividing BH, or kv rows != BH / group
        with pytest.raises(ValueError):
            ops.mqr_sparse_attention(q, kb, kb, ids, 10, group=bad)


# -- #10 rmsnorm -------------------------------------------------------------


@pytest.mark.parametrize("against", AGAINST)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("r,d", [(64, 128), (300, 256), (1, 512)])
def test_rmsnorm_sweep(against, dtype, r, d):
    jx, tx = _both(_normal(r + d, (r, d)), dtype)
    s = _normal(r + d + 1, (d,))
    got = ops.rmsnorm(tx, torch.from_numpy(s))
    assert got.dtype == tx.dtype and got.shape == (r, d)
    fn = ref_ops.rmsnorm if against == "pallas" else ref_ops.rmsnorm_ref
    _close(got, fn(jx, jnp.asarray(s)), NORM_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_bf16_scale_and_eps(dtype):
    """A bfloat16 scale is read as float32, as the reference reads it."""
    jx, tx = _both(_normal(7, (300, 256)) * 1e-3, dtype)
    js, ts = _both(_normal(8, (256,)), "bfloat16")
    for eps in (1e-6, 1e-2):
        got = ops.rmsnorm(tx, ts, eps)
        _close(got, ref_ops.rmsnorm(jx, js, eps), NORM_TOL[dtype])
        _close(got, ref_ops.rmsnorm_ref(jx, js, eps), NORM_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("r,d,offset", [(3, 2050, 0), (4, 256, 1), (1, 2050, 1)])
def test_rmsnorm_odd_width_and_unaligned_base(dtype, r, d, offset):
    """Rows that cannot be read in 16-byte vectors (a width that is no
    multiple of the vector, a contiguous view one element off alignment)
    are taken as they are: no alignment is required of x."""
    a = _normal(r * d + offset, (r * d + offset,))
    jx, _ = _both(a[offset:].reshape(r, d), dtype)
    _, buf = _both(a, dtype)
    tx = buf[offset:].view(r, d)
    s = _normal(d + 5, (d,))
    got = ops.rmsnorm(tx, torch.from_numpy(s))
    assert got.dtype == tx.dtype and got.shape == (r, d)
    _close(got, ref_ops.rmsnorm_ref(jx, jnp.asarray(s)), NORM_TOL[dtype])


def test_rmsnorm_checks_arguments():
    x = torch.zeros((4, 16))
    with pytest.raises(ValueError):
        ops.rmsnorm(x, torch.zeros(8))
    with pytest.raises(TypeError):
        ops.rmsnorm(x.to(torch.float16), torch.zeros(16))
    with pytest.raises(ValueError):
        ops.rmsnorm(x.T, torch.zeros(4))


def test_oracle_names_are_the_plain_versions():
    assert ops.flash_attention_ref is ops.flash_attention_torch
    assert ops.mqr_sparse_attention_ref is ops.mqr_sparse_attention_torch
    assert ops.rmsnorm_ref is ops.rmsnorm_torch
