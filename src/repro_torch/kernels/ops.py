"""Public kernel wrappers and the device policy of the port.

Counterpart of ``repro.kernels.ops``.  Where the JAX package chose between
compiled and interpreted Pallas (``interpret_default``), the port chooses a
device: entry points run on the CUDA card unless the caller passes
``device="cpu"``, and without a card they raise instead of quietly running
on the CPU.  A tensor on the CPU takes each kernel's plain PyTorch version;
a CUDA tensor always launches the kernel.
"""

from __future__ import annotations

import torch

from ._lib import counters as counters  # noqa: F401 (re-export)
from .build import build_levels as build_levels  # noqa: F401
from .build import build_levels_torch as build_levels_torch  # noqa: F401
from .build import device_schedule as device_schedule  # noqa: F401
from .build import hilbert_keys as hilbert_keys  # noqa: F401
from .build import hilbert_permute as hilbert_permute  # noqa: F401
from .flash_attention import FlashAttention as FlashAttention  # noqa: F401
from .flash_attention import flash_attention as flash_attention  # noqa: F401
from .flash_attention import flash_attention_bwd as flash_attention_bwd  # noqa: F401
from .flash_attention import (  # noqa: F401
    flash_attention_bwd_torch as flash_attention_bwd_torch,
)
from .flash_attention import flash_attention_lse as flash_attention_lse  # noqa: F401
from .flash_attention import (  # noqa: F401
    flash_attention_lse_torch as flash_attention_lse_torch,
)
from .flash_attention import flash_attention_torch as flash_attention_torch  # noqa: F401
from .join_scan import fused_join as fused_join  # noqa: F401
from .join_scan import join_epilogue as join_epilogue  # noqa: F401
from .join_scan import pair_sweep as pair_sweep  # noqa: F401
from .join_scan import pair_sweep_torch as pair_sweep_torch  # noqa: F401
from .mbr_scan import mbr_scan as mbr_scan  # noqa: F401
from .mbr_scan import mbr_scan_cm as mbr_scan_cm  # noqa: F401
from .mbr_scan import mbr_scan_torch as mbr_scan_torch  # noqa: F401
from .mqr_sparse_attention import mqr_sparse_attention as mqr_sparse_attention  # noqa: F401
from .mqr_sparse_attention import (  # noqa: F401
    mqr_sparse_attention_torch as mqr_sparse_attention_torch,
)
from .pyramid_scan import fused_search_compact_live as fused_search_compact_live  # noqa: F401
from .pyramid_scan import fused_search_live as fused_search_live  # noqa: F401
from .pyramid_scan import level_sweep as level_sweep  # noqa: F401
from .pyramid_scan import level_sweep_hier as level_sweep_hier  # noqa: F401
from .pyramid_scan import level_sweep_hier_torch as level_sweep_hier_torch  # noqa: F401
from .pyramid_scan import level_sweep_stream as level_sweep_stream  # noqa: F401
from .pyramid_scan import level_sweep_stream_torch as level_sweep_stream_torch  # noqa: F401
from .pyramid_scan import level_sweep_torch as level_sweep_torch  # noqa: F401
from .pyramid_scan import parent_windows as parent_windows  # noqa: F401
from .pyramid_scan import per_level_region_search as per_level_region_search  # noqa: F401
from .pyramid_scan import pyramid_scan as pyramid_scan  # noqa: F401
from .pyramid_scan import pyramid_scan_compact as pyramid_scan_compact  # noqa: F401
from .pyramid_scan import pyramid_scan_compact8 as pyramid_scan_compact8  # noqa: F401
from .pyramid_scan import stream_windows as stream_windows  # noqa: F401
from .quantize import grid_params as grid_params  # noqa: F401
from .quantize import quantize_cm as quantize_cm  # noqa: F401
from .quantize import quantize_cm_torch as quantize_cm_torch  # noqa: F401
from .quantize import quantize_rows as quantize_rows  # noqa: F401
from .quantize import quantize_schedule as quantize_schedule  # noqa: F401
from .rmsnorm import RMSNorm as RMSNorm  # noqa: F401
from .rmsnorm import rmsnorm as rmsnorm  # noqa: F401
from .rmsnorm import rmsnorm_bwd as rmsnorm_bwd  # noqa: F401
from .rmsnorm import rmsnorm_bwd_torch as rmsnorm_bwd_torch  # noqa: F401
from .rmsnorm import rmsnorm_torch as rmsnorm_torch  # noqa: F401

# The plain versions under the reference's oracle names (``repro.kernels.ops``
# re-exports ``ref.*_ref``); each is the same function as its ``*_torch``.
flash_attention_ref = flash_attention_torch
mqr_sparse_attention_ref = mqr_sparse_attention_torch
rmsnorm_ref = rmsnorm_torch


def load_kernels(device) -> None:
    """Build (once) and load the hand-written kernels when ``device`` is a
    CUDA device; nothing on the CPU.  Callers that must not mistake a
    failed build for a failed launch (the serving ladder) call this before
    their first launch, so an ``nvcc`` or load error raises here."""
    if torch.device(device).type == "cuda":
        from . import _lib

        _lib.load()


def default_device() -> torch.device:
    """The device an entry point uses when the caller names none: the CUDA
    card.  Raises when there is no card — running on the CPU has to be
    asked for with ``device="cpu"``."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions "
            "of the kernels on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device=None) -> torch.device:
    """``None`` -> :func:`default_device`; otherwise the named device,
    which must be ``cpu``, an available ``cuda`` device or ``meta``
    (shapes and dtypes only: the dry run, ``launch/dryrun.py``)."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"repro_torch runs on cuda or cpu (or meta), not {dev}")
    return dev
