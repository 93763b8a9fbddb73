"""Fused RMSNorm over the last dimension (kernel #10).

Counterpart of ``repro.kernels.rmsnorm``.  On a CUDA tensor :func:`rmsnorm`
launches ``csrc/rmsnorm.cu``; on a CPU tensor it runs :func:`rmsnorm_torch`,
the counterpart of ``repro.kernels.ref.rmsnorm_ref``.

The kernel reads each row once into registers with 16-byte loads, reduces
its sum of squares with shuffles and writes the output from the registers
with 16-byte stores; a persistent grid walks the rows, each block holding
its share of ``scale`` in registers.  A row that cannot be read in 16-byte
vectors (D not a multiple of 4 floats or 8 bfloat16, or a base off 16-byte
alignment, which a contiguous view may have) takes a scalar path, so x
needs no alignment.
"""

from __future__ import annotations

import torch

from . import _lib


def rmsnorm_torch(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Plain version: ``x * rsqrt(mean(x^2) + eps) * scale`` in float32,
    returned in x's dtype."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of x (..., D) float32 or bfloat16 with scale (D,) float32 or
    bfloat16 -> x's shape and dtype.  Any number of rows, no padding."""
    x_code = _lib.dtype_code(x, "x")
    s_code = _lib.dtype_code(scale, "scale")
    if x.dim() < 1:
        raise ValueError("x must have at least one dimension")
    d = x.shape[-1]
    _lib.require(x, "x", x.dtype)
    _lib.require(scale, "scale", scale.dtype, (d,))
    _lib.require_device({"scale": scale}, x.device)
    if x.device.type == "cpu":
        return rmsnorm_torch(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on cuda or cpu, not {x.device}")
    out = torch.empty_like(x)
    if out.numel():
        rc = _lib.load().repro_rmsnorm(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), x.numel() // d, d,
            x_code, s_code, float(eps), _lib.stream_of(x),
        )
        _lib.check(rc, "rmsnorm")
        _lib.counters.add("rmsnorm")
        _lib.counters.add(f"rmsnorm_{_lib.DTYPE_NAMES[x.dtype]}")
    return out
