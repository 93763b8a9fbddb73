"""mqr-KV block-table decode attention (kernel #9).

Counterpart of ``repro.kernels.mqr_sparse_attention``: attend over only the
K KV blocks that the mqr index chose (``repro_torch.core.kvindex``).  On a
CUDA tensor :func:`mqr_sparse_attention` launches
``csrc/mqr_sparse_attention.cu``; on a CPU tensor it runs
:func:`mqr_sparse_attention_torch`, the counterpart of
``repro.kernels.ref.mqr_sparse_attention_ref``.

An id outside [0, nb) reads the block the reference's jnp gather reads
(a negative id counts from the end, numpy's rule, then the index is
clamped to [0, nb - 1]) and is masked by its own position ``id * bs + j``;
the wrapper never reads ``ids`` or ``pos`` on the host.

``group`` maps query rows to kv rows for grouped-query attention: query
row r reads kv row ``r // group`` of k and v blocks (BH / group, nb, bs, D),
so a model's cache is read in place rather than copied once per query head
(``group=1``, the default, is the reference's signature).

On the card the kernel reads each distinct selected (kv row, block) once
for all the query heads of its group that selected it, weighed by how
often each head selected it, through rings of TMA bulk copies; one launch
splits a group's blocks over enough thread blocks to fill the card and
a second launch merges their partial softmaxes.
The order of the sums is not the reference's walk over the ids (ROADMAP
C30).

On a ``meta`` tensor (the dry run) the wrapper runs the card's argument
checks and returns an empty output, with a partials workspace sized as the
card's for one resident block an SM (the card sizes it from its occupancy,
which ``meta`` cannot ask); no plain version runs there.  On every device
each call reports 4·BH·K·bs·D FLOPs to an active ``OpCost``
(``_lib.reported``) and the bytes of q, of each query row's K selected
blocks of k and v, and of the output: the walk's upper bound, which counts
a block that several heads of a group select once for each.
"""

from __future__ import annotations

import math

import torch

from . import _lib

NEG_INF = -1e30  # the reference's finite mask value (exp(NEG - NEG) = 1, never NaN)
MAX_D = 256      # the kernel's widest head dim
MAX_NB = 65_536  # blocks a kv row may hold on the card (the kernel's bitmap of ids)
H100_SMS = 132   # SMs of the H100 SXM: the partials' size on ``meta``


def _scale(d: int) -> float:
    return 1.0 / math.sqrt(d)


def check_kernel_shape(d: int, nb: int, dtype: torch.dtype) -> None:
    """Raise ``ValueError`` for a shape the card's kernel does not take: D
    must be a positive multiple of 16 bytes' worth of elements, at most
    ``MAX_D``, and a kv row at most ``MAX_NB`` blocks."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    if d < 1 or d > MAX_D or d % vec:
        raise ValueError(f"the kernel takes D a multiple of {vec} up to {MAX_D} in {dtype}, "
                         f"got {d}")
    if nb > MAX_NB:
        raise ValueError(f"the kernel takes at most {MAX_NB} blocks a kv row, got {nb}")


def mqr_sparse_attention_torch(q, k_blocks, v_blocks, ids, pos, group: int = 1) -> torch.Tensor:
    """Plain version: softmax over the K * bs gathered logits in float32
    (products of the input type, float32 sums), p cast to v's dtype before
    P.V, output in q's dtype.  ``pos`` is a Python int or a 0-d tensor;
    query row r reads kv row ``r // group``."""
    bh, d = q.shape
    nb, bs = k_blocks.shape[1], k_blocks.shape[2]
    ids = ids.to(torch.int64)
    rows = torch.div(torch.arange(bh, device=ids.device), group, rounding_mode="floor")[:, None]
    safe = torch.where(ids < 0, ids + nb, ids).clamp(0, nb - 1)
    kg = k_blocks[rows, safe].to(torch.float32)  # (BH, K, bs, D)
    vg = v_blocks[rows, safe]
    logits = torch.einsum("bd,bksd->bks", q.to(torch.float32), kg) * _scale(d)
    kpos = ids[:, :, None] * bs + torch.arange(bs, device=ids.device)
    logits = torch.where(kpos <= pos, logits, NEG_INF)
    p = torch.softmax(logits.reshape(bh, -1), dim=-1)
    out = torch.einsum("bn,bnd->bd", p.to(v_blocks.dtype).to(torch.float32),
                       vg.reshape(bh, -1, d).to(torch.float32))
    return out.to(q.dtype)


def mqr_sparse_attention(q, k_blocks, v_blocks, ids, pos, group: int = 1) -> torch.Tensor:
    """Decode attention of q (BH, D) over the blocks ``ids`` (BH, K) int32
    of k_blocks, v_blocks (BH / group, nb, bs, D) — query row r reads kv row
    ``r // group`` — keys past ``pos`` (inclusive causal limit: a Python int
    or a 0-d integer tensor) masked -> (BH, D) in q's dtype.  float32 or
    bfloat16.  On the card D is a multiple of 16 bytes' worth of elements
    up to 256, nb at most 65,536 (:func:`check_kernel_shape`), and any bs
    and K >= 1; the kernel takes a float32 workspace of partials, merged
    by a second launch (the pair counts as one launch)."""
    code = _lib.dtype_code(q, "q")
    if k_blocks.dim() != 4:
        raise ValueError(f"k_blocks must be (BH, nb, bs, D), got {tuple(k_blocks.shape)}")
    if not isinstance(group, int) or group < 1 or q.dim() != 2 or q.shape[0] % group:
        raise ValueError(f"group must be a positive int dividing BH, got {group} for q "
                         f"{tuple(q.shape)}")
    nb, bs, d = k_blocks.shape[1:]
    bh = q.shape[0]
    if k_blocks.shape[0] != bh // group:
        raise ValueError(f"k_blocks must hold BH / group = {bh // group} kv rows, got "
                         f"{tuple(k_blocks.shape)}")
    _lib.require(q, "q", q.dtype, (bh, d))
    _lib.require(k_blocks, "k_blocks", q.dtype)
    _lib.require(v_blocks, "v_blocks", q.dtype, k_blocks.shape)
    if ids.dim() != 2 or ids.shape[0] != bh or ids.shape[1] < 1:
        raise ValueError(f"ids must be (BH = {bh}, K >= 1), got {tuple(ids.shape)}")
    _lib.require(ids, "ids", torch.int32)
    dev = q.device
    _lib.require_device({"k_blocks": k_blocks, "v_blocks": v_blocks, "ids": ids}, dev)
    if isinstance(pos, torch.Tensor):
        if pos.numel() != 1 or pos.dtype.is_floating_point or pos.dtype == torch.bool:
            raise ValueError(f"pos must be one integer, got {pos.dtype} {tuple(pos.shape)}")
        pos = pos.reshape(())
    else:
        pos = int(pos)
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"mqr_sparse_attention runs on cuda, cpu or meta, not {dev}")
    kk = ids.shape[1]
    cost = (4 * bh * kk * bs * d,
            (2 * bh * d + 2 * bh * kk * bs * d) * q.element_size())
    with _lib.reported("mqr_sparse_attention", *cost):
        if dev.type == "cpu":
            return mqr_sparse_attention_torch(q, k_blocks, v_blocks, ids, pos, group)
        check_kernel_shape(d, nb, q.dtype)
        if dev.type == "meta":
            return _meta_call(q, bs, kk, group)
        return _launch(q, k_blocks, v_blocks, ids, pos, group, code)


def _meta_call(q, bs: int, kk: int, group: int) -> torch.Tensor:
    """The output and the partials of one call on ``meta``: the card's
    plan (``plan_of`` in ``csrc/mqr_sparse_attention.cu``) with one
    resident block an SM."""
    bh, d = q.shape
    gs = 8
    while group % gs:
        gs //= 2
    row = d * q.element_size()
    want = min(max(2048 // row, 32 // gs), 8192 // row, 32)  # STAGE_MIN, STAGE_MAX
    tk = 1
    while tk * 2 <= want and bs % (tk * 2) == 0:
        tk *= 2
    groups, n_ids = bh // gs, gs * kk
    splits = max(1, H100_SMS // groups, -(-n_ids // 252))  # ITEM_CAP - 4 ids a share
    splits = min(splits, n_ids * (bs // tk), 1024)          # MAX_SPLITS
    if bh:
        torch.empty((groups * splits * gs * (d + 4),), dtype=torch.float32, device=q.device)
    return torch.empty((bh, d), dtype=q.dtype, device=q.device)


def _launch(q, k_blocks, v_blocks, ids, pos, group: int, code: int) -> torch.Tensor:
    """Kernel #9 on the card (two launches, counted as one)."""
    bh, d = q.shape
    nb, bs = k_blocks.shape[1:3]
    dev = q.device
    lib = _lib.load()
    for name, t in (("k_blocks", k_blocks), ("v_blocks", v_blocks)):
        _lib.require_aligned(t, name)
    # a tensor pos stays on the device (no host read); an int goes by value
    if isinstance(pos, torch.Tensor):
        pos_dev = pos.to(device=dev, dtype=torch.int32)
        pos_ptr, pos_value = pos_dev.data_ptr(), 0
    else:
        pos_ptr, pos_value = None, pos
    out = torch.empty((bh, d), dtype=q.dtype, device=dev)
    if bh:
        n_part = lib.repro_mqr_sparse_attention_workspace(bh, nb, bs, ids.shape[1], d, group,
                                                          code)
        if n_part < 0:
            _lib.check(int(-n_part), "mqr_sparse_attention")
        part = torch.empty((n_part,), dtype=torch.float32, device=dev)
        rc = lib.repro_mqr_sparse_attention(
            q.data_ptr(), k_blocks.data_ptr(), v_blocks.data_ptr(), ids.data_ptr(), pos_ptr,
            pos_value, part.data_ptr(), out.data_ptr(), bh, nb, bs, ids.shape[1], d, group, code,
            _scale(d), _lib.stream_of(q),
        )
        _lib.check(rc, "mqr_sparse_attention")
        _lib.counters.add("mqr_sparse_attention")
        _lib.counters.add(f"mqr_sparse_attention_{_lib.DTYPE_NAMES[q.dtype]}")
    return out
