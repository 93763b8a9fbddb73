"""Causal flash-attention forward (kernel #8).

Counterpart of ``repro.kernels.flash_attention``.  On a CUDA tensor
:func:`flash_attention` launches ``csrc/flash_attention.cu``; on a CPU
tensor it runs :func:`flash_attention_torch`, the counterpart of
``repro.kernels.ref.flash_attention_ref``.

``block_q`` and ``block_k`` keep the reference's signature and its rule
that S is a multiple of both (a ``ValueError`` here, an assert there); the
kernel's own tiles are fixed and need no such rule: rows and keys past S
are zero-filled and never stored.

bfloat16 runs on Hopper's tensor cores: a producer warpgroup loads Q once
and K/V tiles of 128 keys into a ring of shared-memory stages with TMA
(``cp.async.bulk.tensor`` over a 3-D tensor map of (BH, S, D), completed on
mbarriers; 64-key tiles at D = 256), and two or three consumer warpgroups
of 64 query rows each run
``wgmma`` (bf16 in, float32 accumulate; P from registers), taking turns so
that one's softmax overlaps another's products.  float32 runs on the CUDA
cores in full float32 (no TF32): 8 x 8 register tiles of logits and
outputs per thread (4 x 8 at D = 128, 4 x 16 at D = 256), Q and K
transposed in shared memory for 16-byte reads, K/V tiles double-buffered
with ``cp.async`` (one buffer each at D = 256, refilled as soon as read).
"""

from __future__ import annotations

import math

import torch

from . import _lib

NEG_INF = -1e30  # the reference's finite mask value
HEAD_DIMS = (64, 128, 256)  # the head dims the kernel is built for


def check_head_dim(d: int) -> None:
    """Raise ``ValueError`` for a head dim the card's kernel is not built for."""
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel is built for D in {HEAD_DIMS}, got {d}")


def flash_attention_torch(q, k, v, causal: bool = True) -> torch.Tensor:
    """Plain version: q, k, v (BH, S, D) -> (BH, S, D); float32 logits and
    softmax, p cast to v's dtype before P.V, output in q's dtype."""
    s, d = q.shape[1], q.shape[2]
    logits = torch.einsum("bqd,bkd->bqk", q.to(torch.float32), k.to(torch.float32))
    logits = logits * (1.0 / math.sqrt(d))
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return out.to(q.dtype)


def flash_attention(q, k, v, *, block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Causal attention over q, k, v (BH, S, D) float32 or bfloat16, kv
    heads already broadcast -> (BH, S, D) in q's dtype.  S must be a
    multiple of ``block_q`` and ``block_k``; on the card D is 64, 128 or 256."""
    code = _lib.dtype_code(q, "q")
    if q.dim() != 3:
        raise ValueError(f"q must be (BH, S, D), got {tuple(q.shape)}")
    bh, s, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        _lib.require(t, name, q.dtype, (bh, s, d))
    if block_q < 1 or block_k < 1 or s % block_q or s % block_k:
        raise ValueError(f"S = {s} must be a multiple of block_q = {block_q} "
                         f"and block_k = {block_k}")
    _lib.require_device({"k": k, "v": v}, q.device)
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    check_head_dim(d)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _lib.require_aligned(t, name)
    out = torch.empty_like(q)
    if out.numel():
        rc = _lib.load().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s, d, code,
            1.0 / math.sqrt(d), _lib.stream_of(q),
        )
        _lib.check(rc, "flash_attention")
        _lib.counters.add("flash_attention")
        _lib.counters.add(f"flash_attention_{_lib.DTYPE_NAMES[q.dtype]}")
    return out
