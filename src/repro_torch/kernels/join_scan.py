"""Levelized tree-vs-tree spatial join: the pair sweep and its epilogue.

Counterpart of ``repro.kernels.join_scan``.  Where ``pyramid_scan`` sweeps
one schedule against a query batch, :func:`pair_sweep` sweeps TWO level
schedules against each other, level-synchronized over their common depth
``K = min(levels_a, levels_b)``:

    P[k, a, b] = P[k-1, parent_a(a), parent_b(b)] & overlaps(A[k, a], B[k, b])

with level 0 the overlap alone for every schedule flavour (root MBRs
contain all their objects, so this is conservative for root-unconditional
trees too, and sentinel slots never activate).  A node pair survives only
if its parent pair did, exactly like the single-index sweep.

On a CUDA tensor :func:`pair_sweep` launches ``csrc/pair_sweep.cu``; on a
CPU tensor it runs :func:`pair_sweep_torch`.  The card's design:

* one launch per level on PyTorch's current stream; level ``k`` reads
  level ``k-1``'s slice of the (K, Wa, Wb) output as its parent mask, so
  the per-level masks live in device memory, not in on-chip scratch, and
  the widths are bounded by device memory (:func:`require_fits`) rather
  than by a scratch ceiling;
* no padding: blocks mask the ragged edge of both widths themselves and
  the output is exactly (K, Wa, Wb); a narrow right side (fewer than 128
  slots, such as a dozen geofence zones) takes one thread per pair of the
  flat plane instead of 32 x 256 tiles that would lie mostly past its edge;
* the parent pair is a plain byte gather ``prev[pa[a], pb[b]]``, read only
  where the pair's own MBRs overlap (the TPU kernel used two one-hot
  matmuls);
* the symmetric self-join sweeps slot pairs ``a <= b`` only (tiles wholly
  below the diagonal store zeros), and reads the mirrored parent mask in
  place as ``prev[pa, pb] | prev[pb, pa]`` instead of materializing
  ``max(prev, prev.T)`` at each level.

The sweep is only required to be CONSERVATIVE.  :func:`join_epilogue`
looks each entry pair up at ``k = min(level_a, level_b)`` through the
ancestor chains of :func:`repro_torch.core.flat.ancestor_chains`, treats
delta-buffer rows as unconditional candidates, and runs an exact float32
object-MBR confirming pass with the tombstone masks, so the pair set equals
the brute-force nested-loop overlap for float32 and uint16 tiles alike;
tile precision only moves the pair-visit counts.  The epilogue is plain
torch in row chunks of bounded size; the ``host`` backend runs the same
:func:`fused_join` on CPU tensors.
"""

from __future__ import annotations

import os

import torch

from repro_torch.core.flat import overlaps

from . import _lib

# Per-chunk budget of the epilogue's temporaries, and the bytes one entry
# pair (candidate lookup) or one object pair (confirming pass) holds in it.
EPILOGUE_CHUNK_BYTES = 2 << 30
_LOOKUP_BYTES_PER_PAIR = 48  # k, its B index, two gathers, their sum (int64) + mask
_CONFIRM_BYTES_PER_PAIR = 8  # bool temporaries of the overlap and masks


def free_bytes(device: torch.device) -> int:
    """Bytes a new allocation on ``device`` can take: free device memory
    plus what PyTorch's caching allocator holds unused (CUDA), or the
    host memory available without swapping (CPU: ``MemAvailable``, which
    counts reclaimable page cache, where the kernel reports it)."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def require_fits(nbytes: int, device: torch.device, what: str) -> None:
    """Raise ``ValueError`` naming the size when ``nbytes`` exceed
    :func:`free_bytes` — before anything is allocated or launched."""
    if device.type == "cuda" and nbytes <= torch.cuda.mem_get_info(device)[0]:
        return  # fits in memory no one holds; the allocator's query costs ~10x more
    free = free_bytes(device)
    if nbytes > free:
        raise ValueError(
            f"{what} needs {nbytes:,} bytes ({nbytes / 2**30:.1f} GiB) but only "
            f"{free:,} bytes ({free / 2**30:.1f} GiB) are free on {device}")


def count_true(mask: torch.Tensor) -> torch.Tensor:
    """Number of True entries of a bool tensor, as a 0-d int64 tensor on
    its device.

    ``mask.sum()`` first copies a bool tensor to int64 (8 bytes an entry:
    45 GiB for a 6 GB pair mask).  Here the bytes are summed 255 at a time
    in uint8, which cannot overflow and needs no copy, and only those
    partial sums (1/255 of the entries) are widened."""
    flat = mask.reshape(-1).view(torch.uint8)
    m = flat.numel() // 255
    head = flat[: m * 255].view(m, 255).sum(dim=1, dtype=torch.uint8)
    return head.sum(dtype=torch.int64) + flat[m * 255:].sum(dtype=torch.int64)


def _overlap_pairs(al: torch.Tensor, bl: torch.Tensor) -> torch.Tensor:
    """(4, Wa) x (4, Wb) coordinate-major tiles -> (Wa, Wb) closed-boundary
    overlap."""
    return ((al[0][:, None] <= bl[2][None, :]) & (bl[0][None, :] <= al[2][:, None])
            & (al[1][:, None] <= bl[3][None, :]) & (bl[1][None, :] <= al[3][:, None]))


def pair_sweep_torch(a_cm: torch.Tensor, a_parent: torch.Tensor, b_cm: torch.Tensor,
                     b_parent: torch.Tensor, *, symmetric: bool = False) -> torch.Tensor:
    """Plain version of the pair sweep: the (K, Wa, Wb) bool pair-active
    mask.  uint16 tiles are widened to int32 (grid cells compare exactly
    either way); ``symmetric`` keeps slot pairs ``a <= b`` only and gathers
    the parents from the mirrored previous level."""
    k_levels, _, wa = a_cm.shape
    wb = b_cm.shape[2]
    a = a_cm if a_cm.dtype == torch.float32 else a_cm.to(torch.int32)
    b = b_cm if b_cm.dtype == torch.float32 else b_cm.to(torch.int32)
    pa, pb = a_parent.to(torch.int64), b_parent.to(torch.int64)
    triu = (torch.ones((wa, wb), dtype=torch.bool, device=a_cm.device).triu()
            if symmetric else None)
    act = torch.empty((k_levels, wa, wb), dtype=torch.bool, device=a_cm.device)
    for k in range(k_levels):
        cur = _overlap_pairs(a[k], b[k])
        if k > 0:
            prev = act[k - 1] | act[k - 1].T if symmetric else act[k - 1]
            cur &= prev[pa[k]][:, pb[k]]
        if symmetric:
            cur &= triu
        act[k] = cur
    return act


def _check_pair_args(a_cm, a_parent, b_cm, b_parent, symmetric):
    if a_cm.dim() != 3 or a_cm.shape[1] != 4 or b_cm.dim() != 3 or b_cm.shape[1] != 4:
        raise ValueError(f"tiles must be (K, 4, W), got {tuple(a_cm.shape)} and "
                         f"{tuple(b_cm.shape)}")
    if a_cm.shape[0] != b_cm.shape[0]:
        raise ValueError("both sides must be trimmed to the same K levels")
    if a_cm.dtype not in (torch.float32, torch.uint16) or b_cm.dtype != a_cm.dtype:
        raise TypeError(f"tiles must be both float32 or both uint16, got {a_cm.dtype} "
                        f"and {b_cm.dtype}")
    k_levels, _, wa = a_cm.shape
    wb = b_cm.shape[2]
    _lib.require(a_cm, "a_cm", a_cm.dtype)
    _lib.require(b_cm, "b_cm", b_cm.dtype)
    _lib.require(a_parent, "a_parent", torch.int32, (k_levels, wa))
    _lib.require(b_parent, "b_parent", torch.int32, (k_levels, wb))
    _lib.require_device({"a_parent": a_parent, "b_cm": b_cm, "b_parent": b_parent},
                        a_cm.device)
    if symmetric and wa != wb:
        raise ValueError("the symmetric sweep needs one schedule on both sides")
    return k_levels, wa, wb


def pair_sweep(a_cm: torch.Tensor, a_parent: torch.Tensor, b_cm: torch.Tensor,
               b_parent: torch.Tensor, *, symmetric: bool = False) -> torch.Tensor:
    """Run the pair sweep; returns the (K, Wa, Wb) bool pair-active mask.

    ``a_cm`` (K, 4, Wa) and ``b_cm`` (K, 4, Wb) are both float32 or both
    uint16 (one joint grid); ``a_parent`` (K, Wa) and ``b_parent`` (K, Wb)
    are int32.  ``symmetric=True`` is the self-join fast path: both sides
    MUST be the same schedule, only slot pairs ``a <= b`` are swept, and
    the mask holds the upper triangle per level (mirror with
    ``act | act.transpose(1, 2)``).  Raises ``ValueError`` before launching
    when the mask does not fit in free memory.
    """
    k_levels, wa, wb = _check_pair_args(a_cm, a_parent, b_cm, b_parent, symmetric)
    require_fits(k_levels * wa * wb, a_cm.device, f"the ({k_levels}, {wa}, {wb}) pair mask")
    if a_cm.device.type == "cpu":
        return pair_sweep_torch(a_cm, a_parent, b_cm, b_parent, symmetric=symmetric)
    if a_cm.device.type != "cuda":
        raise ValueError(f"pair_sweep runs on cuda or cpu, not {a_cm.device}")
    tile_u16 = a_cm.dtype == torch.uint16
    act = torch.empty((k_levels, wa, wb), dtype=torch.uint8, device=a_cm.device)
    rc = _lib.load().repro_pair_sweep(
        a_cm.data_ptr(), a_parent.data_ptr(), b_cm.data_ptr(), b_parent.data_ptr(),
        act.data_ptr(), int(tile_u16), int(symmetric), k_levels, wa, wb,
        _lib.stream_of(a_cm),
    )
    _lib.check(rc, "pair_sweep")
    _lib.counters.add("pair_sweep_u16" if tile_u16 else "pair_sweep_f32", k_levels)
    if symmetric:
        _lib.counters.add("pair_sweep_sym", k_levels)
    return act.view(torch.bool)


def _require_unique(gid: torch.Tensor, name: str) -> None:
    """Each object is one schedule entry (one leaf entry per object in the
    trees, ``arange`` in the pyramid, remapped through the bijective
    ``base_gids`` on a live side), so entry gids are unique and the
    epilogue's scatter is a plain assignment; a schedule that broke this
    would make it ambiguous, so it fails loudly."""
    if torch.unique(gid).numel() != gid.numel():
        raise ValueError(f"{name} repeats a global id; the join needs one entry per object")


def _epilogue_bytes(ea: int, eb: int, na: int, nb: int) -> int:
    """The epilogue's working set: the dense (Na, Nb) pair mask plus one
    chunk of temporaries."""
    return na * nb + min(EPILOGUE_CHUNK_BYTES, max(ea * eb * _LOOKUP_BYTES_PER_PAIR,
                                                   na * nb * _CONFIRM_BYTES_PER_PAIR))


def join_epilogue(
    act, a_anc, a_level, a_gid, b_anc, b_level, b_gid, table_a, table_b,
    alive_a, alive_b, delta_a, delta_b, *, symmetric: bool = False,
):
    """Candidate lookup + exact confirming pass; plain torch on ``act``'s
    device.  Returns ``(pairs (Na, Nb) bool, visits (K + 2,) int64)``.

    Entry pair (ea, eb) is a candidate iff the pair mask is active at
    ``k = min(level_a, level_b)`` (for a symmetric sweep: at ``(sa, sb)``
    or ``(sb, sa)``, the upper triangle read both ways).  Candidates land
    at their global ids; delta-buffer rows become candidates against every
    object; the exact float32 overlap and the tombstone masks make the
    result equal the brute-force oracle.  Both passes walk row chunks
    whose temporaries stay within ``EPILOGUE_CHUNK_BYTES``.  ``visits`` holds the
    per-level sums of the unmirrored sweep mask, then one column per side
    counting the delta cross-scan's exact tests.
    """
    dev = act.device
    k_levels, wa, wb = act.shape
    ea, eb = a_level.shape[0], b_level.shape[0]
    na, nb = table_a.shape[0], table_b.shape[0]
    _require_unique(a_gid, "a_gid")
    _require_unique(b_gid, "b_gid")
    flat = act.reshape(-1)
    la, lb = a_level.to(torch.int64), b_level.to(torch.int64)
    # Per entry and level, the flat offset of its ancestor's mask row (as
    # the first index) and its ancestor's slot (as the second), so that one
    # entry pair's mask byte is row_a[ea, k] + anc_b[eb, k].
    level_base = torch.arange(k_levels, device=dev)[None, :] * wa
    anc_a, anc_b = a_anc.to(torch.int64), b_anc.to(torch.int64)
    row_a = (level_base + anc_a) * wb
    row_b = ((level_base + anc_b) * wb).reshape(-1) if symmetric else None
    anc_b = anc_b.reshape(-1)
    col_b = torch.arange(eb, device=dev)[None, :] * k_levels
    gid_a, gid_b = a_gid.to(torch.int64), b_gid.to(torch.int64)[None, :]
    pairs = torch.zeros((na, nb), dtype=torch.bool, device=dev)
    step = max(1, EPILOGUE_CHUNK_BYTES // max(1, eb * _LOOKUP_BYTES_PER_PAIR))
    for s in range(0, ea, step):
        k = torch.minimum(la[s:s + step, None], lb[None, :])       # (C, Eb)
        kb = col_b + k
        cand = flat[row_a[s:s + step].gather(1, k) + anc_b[kb]]
        if symmetric:  # the upper triangle, read both ways
            cand |= flat[row_b[kb] + anc_a[s:s + step].gather(1, k)]
        pairs[gid_a[s:s + step, None], gid_b] = cand
    step = max(1, EPILOGUE_CHUNK_BYTES // max(1, nb * _CONFIRM_BYTES_PER_PAIR))
    for s in range(0, na, step):
        rows = slice(s, s + step)
        exact = overlaps(table_a[rows, None, :], table_b[None, :, :])
        keep = (pairs[rows] | delta_a[rows, None] | delta_b[None, :]) & exact
        pairs[rows] = keep & alive_a[rows, None] & alive_b[None, :]
    visits = torch.stack([
        *(count_true(act[k]) for k in range(k_levels)),
        count_true(delta_a) * count_true(alive_b),
        count_true(delta_b) * count_true(alive_a),
    ])
    return pairs, visits


def fused_join(
    a_cm, a_parent, a_anc, a_level, a_gid,
    b_cm, b_parent, b_anc, b_level, b_gid,
    table_a, table_b, alive_a, alive_b, delta_a, delta_b,
    *, symmetric: bool = False, engine: str = "kernel",
):
    """Tree-vs-tree spatial join: :func:`pair_sweep` (kernel #6, one launch
    per level, on a CUDA tensor) + :func:`join_epilogue`; ``engine="torch"``
    sweeps with :func:`pair_sweep_torch` on any device instead (the
    ``torch`` backend and the serving ladder's ``torch`` rung).

    Both sides arrive as their first ``K`` schedule levels (float32 tiles,
    or uint16 tiles on one JOINT grid for ``precision="compact"``), int32
    parents, per-entry ancestor chains (E, K), entry levels and global ids,
    float32 global-id MBR tables, ``alive`` tombstone masks and delta-row
    masks, all on one device.  Returns ``(pairs (Na, Nb) bool, visits
    (K + 2,) int64)``.  ``symmetric=True`` (self-join: both sides the same
    schedule and live state) sweeps the upper pair triangle only; the pair
    set is unchanged.  Raises ``ValueError`` before any launch when the
    mask plus the epilogue's working set exceed free memory.
    """
    k_levels, wa = a_cm.shape[0], a_cm.shape[2]
    wb = b_cm.shape[2]
    need = k_levels * wa * wb + _epilogue_bytes(
        a_level.shape[0], b_level.shape[0], table_a.shape[0], table_b.shape[0])
    require_fits(need, a_cm.device,
                 f"the join's ({k_levels}, {wa}, {wb}) pair mask and its "
                 f"({table_a.shape[0]}, {table_b.shape[0]}) epilogue")
    if engine == "kernel":
        act = pair_sweep(a_cm, a_parent, b_cm, b_parent, symmetric=symmetric)
    elif engine == "torch":
        _check_pair_args(a_cm, a_parent, b_cm, b_parent, symmetric)
        act = pair_sweep_torch(a_cm, a_parent, b_cm, b_parent, symmetric=symmetric)
    else:
        raise ValueError(f"unknown join engine {engine!r}; expected 'kernel' or 'torch'")
    return join_epilogue(
        act, a_anc, a_level, a_gid, b_anc, b_level, b_gid, table_a, table_b,
        alive_a, alive_b, delta_a, delta_b, symmetric=symmetric)

