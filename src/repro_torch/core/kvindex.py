"""mqr-KV: the paper's spatial index over a transformer KV cache.

Counterpart of ``repro.core.kvindex`` (DESIGN.md §3.2).  KV positions are
grouped into fixed-size blocks; each block gets a 2-D MBR over
``(token position, k·u)`` where ``u`` is a per-head probe direction.  Blocks
are organised by the mqr quadrant-centroid rule (the group pyramid of
:mod:`repro_torch.core.bulk`), and a decode query runs a region search —
position window × query-dependent score range — to pick the K most relevant
blocks, which ``ops.mqr_sparse_attention`` (kernel #9) then attends over.

The functions index one (batch, kv head) at a time, as in the reference,
and also take leading row dimensions, the counterpart of the reference's
``vmap`` over (batch, kv head): keys (R, S, d) with probes (R, d) build R
indexes in one pass, and regions (R, G, 4) select ids (R, G, K), row r's
regions in row r's index.  A row's index and ids equal its single-row
build's exactly: dot products run in one fixed pairwise order
(:func:`dot`), so a row's scores do not depend on how many rows are built
together, and nothing in a build or a selection reads a tensor on the host.
:func:`select_blocks` and :func:`select_blocks_batched` also take a batch of
regions (G, 4) for one index.

Selection equals the reference's exactly: scores stay float32 (``1e6 +
area`` ties where the reference's do), a clipped zero is +0.0 as
``jnp.clip`` gives it, and the top K come from a stable descending sort, so
equal scores keep ascending block order as ``jax.lax.top_k`` keeps them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.ops import resolve_device

from .bulk import GroupPyramid, _group_bounds, build_pyramid, pyramid_search

DEFAULT_BLOCK = 128
DEFAULT_LEVELS = 6
# The "empty" score bound of an unwritten block: finite, as in the reference.
EMPTY_SCORE = 3.4e38


class KVIndex(NamedTuple):
    block_mbr: torch.Tensor  # (nb, 4) f32: [lo_pos, lo_score, hi_pos, hi_score]
    pyramid: GroupPyramid    # mqr group pyramid over the block MBR centroids


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Float32 dot products over the last dimension of a and b (broadcast),
    summed in one fixed pairwise order: elementwise passes only, so a row's
    result is the same whatever rows are computed beside it, on any
    device (a batched matrix product may change its order with the batch)."""
    x = _f32(a) * _f32(b)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        y = x[..., :h] + x[..., h:2 * h]
        x = torch.cat([y, x[..., 2 * h:]], dim=-1) if x.shape[-1] % 2 else y
    return x[..., 0]


def block_mbrs(keys: torch.Tensor, probe: torch.Tensor, block_size: int) -> torch.Tensor:
    """Per-block MBRs in (position, score) space.

    keys: (S, d); probe: (d,) -> (nb, 4); or rows, keys (R, S, d) and
    probes (R, d) -> (R, nb, 4).  S must be a multiple of block_size.
    Scores are float32 dot products, as the reference's bf16 @ f32
    promotes."""
    s = keys.shape[-2]
    if s % block_size:
        raise ValueError(f"S = {s} is not a multiple of block_size = {block_size}")
    nb = s // block_size
    scores = dot(keys, probe[..., None, :]).reshape(*keys.shape[:-2], nb, block_size)
    pos = torch.arange(s, dtype=torch.float32, device=keys.device).reshape(nb, block_size)
    pos_lo, pos_hi = (p.expand(scores.shape[:-1]) for p in (pos.amin(1), pos.amax(1)))
    return torch.stack(
        [pos_lo, scores.amin(-1), pos_hi, scores.amax(-1)], dim=-1
    )


def build_kv_index(
    keys: torch.Tensor,
    probe: torch.Tensor,
    block_size: int = DEFAULT_BLOCK,
    levels: int = DEFAULT_LEVELS,
) -> KVIndex:
    bm = block_mbrs(keys, probe, block_size)
    return KVIndex(block_mbr=bm, pyramid=build_pyramid(bm, levels))


def query_region(
    q: torch.Tensor,
    probe: torch.Tensor,
    kv_len,
    score_halfwidth: float = 2.0,
    pos_lo: float = 0.0,
) -> torch.Tensor:
    """Decode-query region: full causal position window x score band around
    the query's own probe projection.  ``q`` (d,) gives (4,); a batch of
    queries (..., d) gives (..., 4), with ``probe`` (d,) or any shape that
    broadcasts against ``q`` (rows: q (R, G, d), probe (R, 1, d)).
    ``kv_len`` is a Python int or a 0-d tensor."""
    sq = dot(q, probe)
    width = score_halfwidth * (sq.abs() + 1.0)
    lo = torch.full_like(sq, pos_lo)
    hi = torch.as_tensor(kv_len).to(device=sq.device, dtype=torch.float32).expand_as(sq)
    return torch.stack([lo, sq - width, hi, sq + width], dim=-1)


def _top_blocks(survive: torch.Tensor, bm: torch.Tensor, region: torch.Tensor,
                k: int) -> torch.Tensor:
    """Survivors strictly first, then larger overlap area; the first k block
    ids of a stable descending sort (ties in ascending id order).  Rows of
    block MBRs (R, nb, 4) take regions (R, G, 4)."""
    nb = bm.shape[-2]
    if not 0 < k <= nb:
        raise ValueError(f"k must be in [1, {nb}], got {k}")
    region = _f32(region)
    if bm.dim() > 2:  # rows of indexes: room for each row's regions
        bm = bm.unsqueeze(-3)
    w = torch.minimum(bm[..., 2], region[..., 2:3]) - torch.maximum(bm[..., 0], region[..., 0:1])
    h = torch.minimum(bm[..., 3], region[..., 3:4]) - torch.maximum(bm[..., 1], region[..., 1:2])
    # ``+ 0.0`` turns a clamped -0.0 into the +0.0 that ``jnp.clip`` gives
    area = (w.clamp(min=0.0) + 0.0) * (h.clamp(min=0.0) + 0.0)
    score = torch.where(survive, 1e6 + area, area)
    order = torch.sort(score, dim=-1, descending=True, stable=True).indices
    return order[..., :k].to(torch.int32)


def select_blocks(index: KVIndex, region: torch.Tensor, k: int) -> torch.Tensor:
    """mqr region search + static top-K.

    Returns (k,) int32 block ids for a region (4,), or (G, k) for regions
    (G, 4); for rows of indexes (built from keys (R, S, d)), regions
    (R, G, 4) give (R, G, k).  Ids repeat only when fewer than k blocks
    survive the region search: survivors come first, then the
    highest-overlap non-survivors as padding (attention over padding is
    still correct, just not pruned)."""
    survive = pyramid_search(index.pyramid, _f32(region))
    return _top_blocks(survive, index.block_mbr, region, k)


def select_blocks_batched(index_mbr, pyramid, regions, k):
    """Helper used by models: regions (H, 4) -> (H, k), in one pass."""
    return select_blocks(KVIndex(index_mbr, pyramid), regions, k)


# ---------------------------------------------------------------------------
# Incremental index maintenance (the reference's beyond-paper optimisation)
#
# The index lives beside the KV cache and is updated per token with monotone
# MBR growth: the new key's (position, score) point is merged into its block
# MBR and into every ancestor group MBR.  Group membership is frozen (from
# the initial position-only pyramid); growth keeps every group MBR a
# superset of its true bounds, so the region search stays conservative.
# ---------------------------------------------------------------------------


class IncKVIndex(NamedTuple):
    block_mbr: torch.Tensor  # (nb, 4)
    group_mbr: torch.Tensor  # (L, nb, 4) — padded by dense group id
    group_of: torch.Tensor   # (L, nb) int32 — frozen membership


def init_incremental(nb: int, block_size: int, levels: int, *, device=None) -> IncKVIndex:
    """Position-only initial pyramid; score extents start empty
    (+3.4e38 / -3.4e38, finite as in the reference) so unwritten blocks never
    overlap a query region.  ``device`` as for every entry point of the port
    (the card unless ``"cpu"`` is asked for)."""
    dev = resolve_device(device)
    pos_lo = torch.arange(nb, dtype=torch.float32, device=dev) * block_size
    pos_hi = pos_lo + (block_size - 1)
    full = torch.full((nb,), EMPTY_SCORE, dtype=torch.float32, device=dev)
    block_mbr = torch.stack([pos_lo, full, pos_hi, -full], dim=-1)
    # membership from the position-centroid pyramid (scores all 0 at freeze
    # time, so splits happen on the position axis)
    zero = torch.zeros((nb,), dtype=torch.float32, device=dev)
    pyr = build_pyramid(torch.stack([pos_lo, zero, pos_hi, zero], dim=-1), levels)
    group_mbr = torch.stack([_group_bounds(g.long(), block_mbr, nb) for g in pyr.group_of])
    return IncKVIndex(block_mbr, group_mbr, pyr.group_of)


def _merge_point(m: torch.Tensor, pf: torch.Tensor, sf: torch.Tensor) -> torch.Tensor:
    """Grow MBR rows m (..., 4) to hold the point (pf, sf)."""
    return torch.stack([torch.minimum(m[..., 0], pf), torch.minimum(m[..., 1], sf),
                        torch.maximum(m[..., 2], pf), torch.maximum(m[..., 3], sf)], dim=-1)


def incremental_update(idx: IncKVIndex, pos, score, block_size: int) -> IncKVIndex:
    """Merge the new key's (pos, score) point into its block + ancestors.

    ``pos`` is a Python number or a 0-d tensor, shared by every row;
    ``score`` a number or a tensor of the index's leading row dimensions
    (indexes (R, nb, 4) ... take scores (R,)).  The block is found on the
    device (no host read of ``pos``).  Returns a new index, as the
    reference does."""
    dev = idx.block_mbr.device
    pos = torch.as_tensor(pos, device=dev)
    b = torch.div(pos, block_size, rounding_mode="floor").to(torch.int64).reshape(1)
    pf = pos.to(torch.float32)
    sf = torch.as_tensor(score, device=dev).to(torch.float32)
    block_mbr = idx.block_mbr.index_copy(
        -2, b, _merge_point(idx.block_mbr.index_select(-2, b), pf, sf[..., None]))
    g = idx.group_of.index_select(-1, b).long()[..., None]
    g = g.expand(*g.shape[:-1], 4)  # (..., L, 1, 4)
    group_mbr = idx.group_mbr.scatter(
        -2, g, _merge_point(torch.gather(idx.group_mbr, -2, g), pf, sf[..., None, None]))
    return IncKVIndex(block_mbr, group_mbr, idx.group_of)


def incremental_select(idx: IncKVIndex, region: torch.Tensor, k: int) -> torch.Tensor:
    """Region search against the incrementally maintained pyramid: reads
    O((L+1)*nb) floats — never the key cache.  Regions as in
    :func:`select_blocks` (rows of indexes take regions (R, G, 4))."""
    survive = pyramid_search(
        GroupPyramid(idx.group_of, idx.group_mbr, idx.group_of.shape[-2]), _f32(region))
    return _top_blocks(survive, idx.block_mbr, region, k)
