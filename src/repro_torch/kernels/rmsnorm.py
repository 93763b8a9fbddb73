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

Training goes through :class:`RMSNorm`, a ``torch.autograd.Function``
whose forward is :func:`rmsnorm` and whose backward launches
``csrc/rmsnorm_bwd.cu`` (:func:`rmsnorm_bwd`: dx row by row, and dscale
from per-block partial sums added in block order, so the same on every
run).  On a CPU tensor each takes its plain version (``*_torch``).

On a ``meta`` tensor (the dry run) each wrapper runs the card's argument
checks and returns empty outputs of the kernel's shapes and dtypes (the
backward with its partials, sized for an H100's 132 SMs); no plain version
runs there.  On every device each call reports its bytes to an active
``OpCost`` (``_lib.reported``; no FLOPs): x and scale read and the output
written; the backward x, dy and scale read and dx and dscale written.
"""

from __future__ import annotations

import torch

from . import _lib

H100_SMS = 132        # SMs of the H100 SXM: the backward's grid on ``meta``
BWD_BLOCKS_PER_SM = 4  # ``BLOCKS_PER_SM`` of ``csrc/rmsnorm_bwd.cu``


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
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"rmsnorm runs on cuda, cpu or meta, not {x.device}")
    with _lib.reported("rmsnorm", 0, 2 * _lib.nbytes(x) + _lib.nbytes(scale)):
        if x.device.type == "cpu":
            return rmsnorm_torch(x, scale, eps)
        return _launch(x, scale, eps, x_code, s_code)


def _launch(x, scale, eps: float, x_code: int, s_code: int) -> torch.Tensor:
    """#10 on the card; on ``meta`` its output, empty."""
    d = x.shape[-1]
    out = torch.empty_like(x)
    if out.numel() and x.device.type == "cuda":
        rc = _lib.load().repro_rmsnorm(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), x.numel() // d, d,
            x_code, s_code, float(eps), _lib.stream_of(x),
        )
        _lib.check(rc, "rmsnorm")
        _lib.counters.add("rmsnorm")
        _lib.counters.add(f"rmsnorm_{_lib.DTYPE_NAMES[x.dtype]}")
    return out


def rmsnorm_bwd_torch(x, scale, dy, eps: float = 1e-6):
    """Plain version of :func:`rmsnorm_bwd`: with r = rsqrt(mean(x^2) + eps)
    and g = scale * dy, dx = r g - x r^3 mean(x g) and dscale = sum over
    rows of dy x r, in float32; dx in x's dtype, dscale in scale's."""
    xf, gf = x.to(torch.float32), dy.to(torch.float32)
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    g = scale.to(torch.float32) * gf
    dx = r * g - xf * (r * r * r) * (xf * g).mean(dim=-1, keepdim=True)
    dscale = (gf * xf * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def rmsnorm_bwd(x, scale, dy, eps: float = 1e-6):
    """The backward of :func:`rmsnorm`: x (..., D) and the output's gradient
    ``dy`` (x's shape and dtype) -> (dx in x's dtype, dscale (D,) in
    scale's dtype)."""
    x_code = _lib.dtype_code(x, "x")
    s_code = _lib.dtype_code(scale, "scale")
    if x.dim() < 1:
        raise ValueError("x must have at least one dimension")
    d = x.shape[-1]
    _lib.require(x, "x", x.dtype)
    _lib.require(dy, "dy", x.dtype, tuple(x.shape))
    _lib.require(scale, "scale", scale.dtype, (d,))
    _lib.require_device({"scale": scale, "dy": dy}, x.device)
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"rmsnorm_bwd runs on cuda, cpu or meta, not {x.device}")
    with _lib.reported("rmsnorm_bwd", 0, 3 * _lib.nbytes(x) + 2 * _lib.nbytes(scale)):
        if x.device.type == "cpu":
            return rmsnorm_bwd_torch(x, scale, dy, eps)
        return _bwd_launch(x, scale, dy, eps, x_code, s_code)


def _bwd_launch(x, scale, dy, eps: float, x_code: int, s_code: int):
    """#10's backward kernel on the card; on ``meta`` its outputs and
    partials, empty."""
    d = x.shape[-1]
    dx, dscale = torch.empty_like(x), torch.empty_like(scale)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return dx, dscale.zero_()
    if x.device.type == "meta":
        blocks = min(rows, H100_SMS * BWD_BLOCKS_PER_SM)
        torch.empty((blocks, d), dtype=torch.float32, device=x.device)
        return dx, dscale
    lib = _lib.load()
    partial = torch.empty((lib.repro_rmsnorm_bwd_blocks(rows), d), dtype=torch.float32,
                          device=x.device)
    rc = lib.repro_rmsnorm_bwd(
        x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
        partial.data_ptr(), rows, d, x_code, s_code, float(eps), _lib.stream_of(x),
    )
    _lib.check(rc, "rmsnorm_bwd")
    _lib.counters.add("rmsnorm_bwd")
    _lib.counters.add(f"rmsnorm_bwd_{_lib.DTYPE_NAMES[x.dtype]}")
    return dx, dscale


class RMSNorm(torch.autograd.Function):
    """RMSNorm with a gradient: the forward is :func:`rmsnorm`, the backward
    :func:`rmsnorm_bwd` (x is kept, r is recomputed from it).  With no
    gradient wanted it launches the forward kernel alone and builds no
    graph."""

    @staticmethod
    def forward(ctx, x, scale, eps: float = 1e-6):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, dy.contiguous(), ctx.eps)
        return dx, dscale, None
