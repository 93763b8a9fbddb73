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

Training goes through :class:`FlashAttention`, a ``torch.autograd.Function``:
its forward launches the same kernel and also stores each row's
log-sum-exp (:func:`flash_attention_lse`); its backward launches
``csrc/flash_attention_bwd.cu`` (:func:`flash_attention_bwd`: two launches,
dQ with Di = rowsum(P o dP), then dK and dV; no atomics, so the result is
the same on every run).  bfloat16 runs all five products on the tensor
cores (``wgmma``, TMA-fed as the forward; P and dS rounded to bf16 as
their operands), float32 on the CUDA cores with register tiles and
``cp.async`` double buffering.  The backward takes D 64, 128 and 256 on
the card, as the forward does.  When no input needs a gradient (serving,
``torch.inference_mode()``), the Function launches exactly what
:func:`flash_attention` launches.  On a CPU tensor each takes its plain
version (``*_torch``).

On a ``meta`` tensor (the dry run, ``repro_torch.launch.dryrun``) each
wrapper runs the card's argument checks and returns empty outputs of the
kernel's shapes and dtypes, with the workspace the card would allocate; no
plain version runs there.  On every device each call reports its cost to
an active ``OpCost`` (``_lib.reported``): the forward 2·BH·S(S+1)·D FLOPs
(causal) and the bytes of q, k and v read and the output (and lse, when
stored) written; the backward 5·BH·S(S+1)·D FLOPs and the bytes of q, k,
v, dout and lse read and dq, dk and dv written.
"""

from __future__ import annotations

import math

import torch

from . import _lib

NEG_INF = -1e30  # the reference's finite mask value
HEAD_DIMS = (64, 128, 256)  # the head dims the kernel is built for
BWD_HEAD_DIMS = HEAD_DIMS  # the head dims the backward kernel is built for


def check_head_dim(d: int) -> None:
    """Raise ``ValueError`` for a head dim the card's kernel is not built for."""
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel is built for D in {HEAD_DIMS}, got {d}")


def check_bwd_head_dim(d: int) -> None:
    """Raise ``ValueError`` for a head dim the card's backward kernel is not
    built for."""
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"the backward kernel is built for D in {BWD_HEAD_DIMS}, got {d}")


def _masked_logits(q, k) -> torch.Tensor:
    """float32 logits q.k^T / sqrt(D), -1e30 where key > query."""
    s, d = q.shape[1], q.shape[2]
    logits = torch.einsum("bqd,bkd->bqk", q.to(torch.float32), k.to(torch.float32))
    logits = logits * (1.0 / math.sqrt(d))
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    return torch.where(mask, logits, NEG_INF)


def flash_attention_torch(q, k, v, causal: bool = True) -> torch.Tensor:
    """Plain version: q, k, v (BH, S, D) -> (BH, S, D); float32 logits and
    softmax, p cast to v's dtype before P.V, output in q's dtype."""
    if causal:
        logits = _masked_logits(q, k)
    else:
        logits = torch.einsum("bqd,bkd->bqk", q.to(torch.float32), k.to(torch.float32))
        logits = logits * (1.0 / math.sqrt(q.shape[2]))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return out.to(q.dtype)


def flash_attention_lse_torch(q, k, v):
    """Plain version of :func:`flash_attention_lse`: the output of
    :func:`flash_attention_torch` and each row's log-sum-exp m + log(l)
    (BH, S) float32, as the kernel forms it from its running max m and sum
    l."""
    logits = _masked_logits(q, k)
    m = logits.amax(dim=-1)
    lse = m + torch.log(torch.exp(logits - m[..., None]).sum(dim=-1))
    return flash_attention_torch(q, k, v), lse


def flash_attention_bwd_torch(q, k, v, lse, dout):
    """Plain version of :func:`flash_attention_bwd`: P recomputed from
    ``lse``, dP = dO.V^T, Di = rowsum(P o dP), dS = P o (dP - Di); dV from
    P rounded to v's dtype (the p the forward multiplied V by).  float32
    math, gradients in q's dtype.  Di equals rowsum(dO o O) in exact
    arithmetic; it is not taken from the forward's output, whose rounding
    to bfloat16 would reach every dS of the row."""
    f = torch.float32
    scale = 1.0 / math.sqrt(q.shape[2])
    qf, kf, vf, df = (t.to(f) for t in (q, k, v, dout))
    s = q.shape[1]
    keep = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    logits = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
    p = torch.where(keep, torch.exp(logits - lse[..., None]), 0.0)
    dv = torch.einsum("bqk,bqd->bkd", p.to(v.dtype).to(f), df)
    dp = torch.einsum("bqd,bkd->bqk", df, vf)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bqk,bkd->bqd", ds, kf) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _check_qkv(q, k, v, block_q: int, block_k: int) -> int:
    """Validate a forward call; returns q's dtype code."""
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
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda, cpu or meta, not {q.device}")
    if q.device.type == "meta":
        check_head_dim(d)
    return code


def _causal_pairs(bh: int, s: int) -> int:
    """BH·S(S+1): twice the (query, key) pairs a causal pass over (BH, S)
    visits.  Each pair costs two products of length D (q.k and p.v), 4·D
    FLOPs, so the forward is 2·D times this."""
    return bh * s * (s + 1)


def _forward_cost(q, k, v, lse: bool):
    """(FLOPs, bytes) of one forward call (the module docstring's rule)."""
    bh, s, d = q.shape
    written = _lib.nbytes(q) + (bh * s * 4 if lse else 0)
    return 2 * _causal_pairs(bh, s) * d, _lib.nbytes(q, k, v) + written


def bwd_workspace_elements(bh: int, s: int) -> int:
    """float32 elements of the backward kernel's workspace (Di and the
    scaled lse, rows padded to 64): ``repro_flash_attention_bwd_workspace``
    of ``csrc/flash_attention_bwd.cu``."""
    return 2 * bh * (-(-s // 64) * 64)


def _launch(q, k, v, code: int, lse) -> torch.Tensor:
    """Kernel #8 on the card, storing each row's log-sum-exp into ``lse``
    unless it is None."""
    bh, s, d = q.shape
    check_head_dim(d)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _lib.require_aligned(t, name)
    out = torch.empty_like(q)
    if out.numel():
        rc = _lib.load().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), bh, s, d, code, 1.0 / math.sqrt(d),
            _lib.stream_of(q),
        )
        _lib.check(rc, "flash_attention")
        _lib.counters.add("flash_attention")
        _lib.counters.add(f"flash_attention_{_lib.DTYPE_NAMES[q.dtype]}")
    return out


def flash_attention(q, k, v, *, block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Causal attention over q, k, v (BH, S, D) float32 or bfloat16, kv
    heads already broadcast -> (BH, S, D) in q's dtype.  S must be a
    multiple of ``block_q`` and ``block_k``; on the card D is 64, 128 or 256."""
    code = _check_qkv(q, k, v, block_q, block_k)
    with _lib.reported("flash_attention", *_forward_cost(q, k, v, lse=False)):
        if q.device.type == "cpu":
            return flash_attention_torch(q, k, v)
        if q.device.type == "meta":
            return torch.empty_like(q)
        return _launch(q, k, v, code, None)


def flash_attention_lse(q, k, v, *, block_q: int = 128, block_k: int = 128):
    """:func:`flash_attention` and each row's log-sum-exp of the scaled,
    masked logits -> (out, lse (BH, S) float32): the same kernel, which
    also stores lse (the forward of :class:`FlashAttention`)."""
    code = _check_qkv(q, k, v, block_q, block_k)
    with _lib.reported("flash_attention", *_forward_cost(q, k, v, lse=True)):
        if q.device.type == "cpu":
            return flash_attention_lse_torch(q, k, v)
        lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
        if q.device.type == "meta":
            return torch.empty_like(q), lse
        return _launch(q, k, v, code, lse), lse


def flash_attention_bwd(q, k, v, lse, dout):
    """The backward of causal attention: q, k, v, the forward's ``lse``
    and the output's gradient ``dout`` -> (dq, dk, dv) in q's dtype.  On
    the card D is 64, 128 or 256 (``ValueError`` otherwise)."""
    code = _lib.dtype_code(q, "q")
    if q.dim() != 3:
        raise ValueError(f"q must be (BH, S, D), got {tuple(q.shape)}")
    bh, s, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v), ("dout", dout)):
        _lib.require(t, name, q.dtype, (bh, s, d))
    _lib.require(lse, "lse", torch.float32, (bh, s))
    _lib.require_device({"k": k, "v": v, "lse": lse, "dout": dout}, q.device)
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention_bwd runs on cuda, cpu or meta, not {q.device}")
    cost = (5 * _causal_pairs(bh, s) * d, _lib.nbytes(q, k, v, dout, lse) + 3 * _lib.nbytes(q))
    with _lib.reported("flash_attention_bwd", *cost):
        if q.device.type == "cpu":
            return flash_attention_bwd_torch(q, k, v, lse, dout)
        return _bwd_launch(q, k, v, lse, dout, code)


def _bwd_launch(q, k, v, lse, dout, code: int):
    """#8's backward kernel on the card; on ``meta`` its outputs and
    workspace, empty."""
    bh, s, d = q.shape
    check_bwd_head_dim(d)
    if q.device.type == "cuda":
        for name, t in (("q", q), ("k", k), ("v", v), ("dout", dout)):
            _lib.require_aligned(t, name)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if q.device.type == "meta":
        torch.empty((bwd_workspace_elements(bh, s),), dtype=torch.float32, device=q.device)
        return dq, dk, dv
    if dq.numel():
        lib = _lib.load()
        work = torch.empty((lib.repro_flash_attention_bwd_workspace(bh, s),),
                           dtype=torch.float32, device=q.device)
        rc = lib.repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(), dout.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), work.data_ptr(),
            bh, s, d, code, 1.0 / math.sqrt(d), _lib.stream_of(q),
        )
        _lib.check(rc, "flash_attention_bwd")
        _lib.counters.add("flash_attention_bwd")
        _lib.counters.add(f"flash_attention_bwd_{_lib.DTYPE_NAMES[q.dtype]}")
        _lib.counters.add(f"flash_attention_bwd_{_lib.DTYPE_NAMES[q.dtype]}_d{d}")
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Causal attention with a gradient, q, k, v (BH, S, D) as
    :func:`flash_attention` takes them: the forward keeps q, k, v and the
    rows' log-sum-exp, the backward runs :func:`flash_attention_bwd`.
    Models call :meth:`call`, which is :func:`flash_attention` itself when
    no gradient is wanted."""

    @staticmethod
    def call(q, k, v) -> torch.Tensor:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return FlashAttention.apply(q, k, v)
        return flash_attention(q, k, v)

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attention_lse(q, k, v)
        ctx.save_for_backward(q, k, v, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, lse, dout.contiguous())
