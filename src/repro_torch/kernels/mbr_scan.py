"""One-level overlap scan: (Q, N) mask of N MBRs against Q queries.

Counterpart of ``repro.kernels.mbr_scan``.  On a CUDA tensor
:func:`mbr_scan` launches ``csrc/mbr_scan.cu``; on a CPU tensor it runs
:func:`mbr_scan_torch`.  :func:`mbr_scan_cm` scans one coordinate-major
level ``mbr_cm[l]`` (4, W) in place (the kernel takes the strides), which
is how ``per_level_region_search`` calls it.
"""

from __future__ import annotations

import torch

from repro_torch.core.flat import overlaps

from . import _lib


def mbr_scan_torch(mbrs: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Plain version: (N, 4) MBRs x (Q, 4) queries -> (Q, N) bool."""
    return overlaps(mbrs[None, :, :], queries[:, None, :])


def _scan(mbrs: torch.Tensor, n: int, cstride: int, estride: int,
          queries: torch.Tensor, block_n: int) -> torch.Tensor:
    """Launch the kernel on N MBRs laid out with the given strides."""
    _lib.require_device({"queries": queries}, mbrs.device)
    if mbrs.device.type != "cuda":
        raise ValueError(f"mbr_scan runs on cuda or cpu, not {mbrs.device}")
    nq = queries.shape[0]
    out = torch.empty((nq, n), dtype=torch.uint8, device=mbrs.device)
    rc = _lib.load().repro_mbr_scan(
        mbrs.data_ptr(), cstride, estride, queries.data_ptr(), out.data_ptr(),
        n, nq, block_n, _lib.stream_of(mbrs),
    )
    _lib.check(rc, "mbr_scan")
    _lib.counters.add("mbr_scan")
    return out.view(torch.bool)


def mbr_scan(mbrs: torch.Tensor, queries: torch.Tensor, *,
             block_n: int = 512) -> torch.Tensor:
    """(N, 4) float32 MBRs x (Q, 4) float32 queries -> (Q, N) bool overlap
    mask (closed boundaries).  ``block_n`` (a multiple of 32, at most 1024)
    is checked and kept for the callers' tiling; the kernel picks its tile
    width from the query count."""
    _lib.require(mbrs, "mbrs", torch.float32)
    _lib.require_block(block_n, "block_n")
    if mbrs.dim() != 2 or mbrs.shape[1] != 4:
        raise ValueError(f"mbrs must be (N, 4), got {tuple(mbrs.shape)}")
    _lib.require(queries, "queries", torch.float32, (queries.shape[0], 4))
    if mbrs.device.type == "cpu":
        return mbr_scan_torch(mbrs, queries)
    return _scan(mbrs, mbrs.shape[0], 1, 4, queries, block_n)


def mbr_scan_cm(mbr_cm_level: torch.Tensor, queries: torch.Tensor, *,
                block_n: int = 512) -> torch.Tensor:
    """:func:`mbr_scan` of one coordinate-major level (4, W), read in place;
    returns (Q, W) bool."""
    _lib.require(mbr_cm_level, "mbr_cm_level", torch.float32)
    _lib.require_block(block_n, "block_n")
    if mbr_cm_level.dim() != 2 or mbr_cm_level.shape[0] != 4:
        raise ValueError(f"mbr_cm_level must be (4, W), got {tuple(mbr_cm_level.shape)}")
    _lib.require(queries, "queries", torch.float32, (queries.shape[0], 4))
    if mbr_cm_level.device.type == "cpu":
        return mbr_scan_torch(mbr_cm_level.T, queries)
    width = mbr_cm_level.shape[1]
    return _scan(mbr_cm_level, width, width, 1, queries, block_n)
