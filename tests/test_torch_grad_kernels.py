"""The gradients of kernels #8 and #10 on the CPU: ``ops.FlashAttention`` and
``ops.RMSNorm`` (``torch.autograd.Function``s whose backward on the card is
``csrc/flash_attention_bwd.cu`` / ``csrc/rmsnorm_bwd.cu``) with their plain
backward math, against autograd of the plain forward versions.

Tolerances: float32 within 1e-5 + 1e-4 |autograd| (the backward sums in
another order: P is recomputed from the stored log-sum-exp, Di summed
from P and dP); bfloat16 against autograd of the plain version on float32
copies of the same inputs, within 2e-2 |want| + 3e-2 x the tensor's RMS
(the gradient is rounded to bfloat16 once, and dV uses p rounded to v's
dtype as the forward does).  The card holds the kernels to the same plain
versions in ``chip_smoke.py``.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rms_mod
from repro_torch.models import attention as attn
from repro_torch.models import modules

F32_TOL = (1e-5, 1e-4)  # atol, rtol


def rand(seed, *shape, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)).to(dtype)


def autograd(fn, inputs, dout):
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    return torch.autograd.grad(fn(*leaves), leaves, dout)


def close(got, want, dtype):
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        if dtype == torch.float32:
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=F32_TOL[0], rtol=F32_TOL[1])
        else:
            w = w.float()
            limit = 2e-2 * w.abs() + 3e-2 * w.pow(2).mean().sqrt()
            assert bool(((g.float() - w).abs() <= limit).all())


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("shape", ((3, 128, 16), (2, 256, 64), (2, 128, 128), (1, 384, 32),
                                   (2, 128, 256)))
def test_flash_attention_function_matches_autograd_of_the_plain_version(shape, dtype):
    q, k, v, do = (rand(i, *shape, dtype=dtype) for i in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.FlashAttention.call(*leaves)
    assert torch.equal(out, ops.flash_attention(q, k, v))  # the serving forward's output
    got = torch.autograd.grad(out, leaves, do)
    if dtype == torch.float32:
        want = autograd(ops.flash_attention_torch, (q, k, v), do)
    else:
        want = autograd(ops.flash_attention_torch, (q.float(), k.float(), v.float()), do.float())
    close(got, want, dtype)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_flash_attention_lse_is_the_rows_logsumexp(dtype):
    """The forward's log-sum-exp (the kernel's m + log(l)) against
    ``torch.logsumexp`` of the scaled, masked logits; its output equals the
    serving forward's."""
    q, k, v = (rand(10 + i, 4, 256, 64, dtype=dtype) for i in range(3))
    out, lse = ops.flash_attention_lse(q, k, v)
    assert lse.dtype == torch.float32 and lse.shape == (4, 256)
    assert torch.equal(out, ops.flash_attention(q, k, v))
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(64)
    logits = torch.where(torch.ones(256, 256, dtype=torch.bool).tril(), logits, -1e30)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(logits, -1).numpy(),
                               atol=1e-5, rtol=1e-6)


def test_flash_attention_backward_is_deterministic_and_checks_its_arguments():
    q, k, v, do = (rand(20 + i, 2, 128, 64) for i in range(4))
    _, lse = ops.flash_attention_lse(q, k, v)
    a = ops.flash_attention_bwd(q, k, v, lse, do)
    b = ops.flash_attention_bwd(q, k, v, lse, do)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="lse"):
        ops.flash_attention_bwd(q, k, v, lse[:, :64].contiguous(), do)
    with pytest.raises(TypeError, match="dout"):
        ops.flash_attention_bwd(q, k, v, lse, do.to(torch.bfloat16))
    # the card's backward kernel takes the forward's head dims, 64, 128 and
    # 256 (checked before any launch)
    assert fa_mod.BWD_HEAD_DIMS == fa_mod.HEAD_DIMS
    for d in (64, 128, 256):
        fa_mod.check_bwd_head_dim(d)
    with pytest.raises(ValueError, match="96"):
        fa_mod.check_bwd_head_dim(96)


def worst_over_limit(got, want, rtol=2e-2, row_rms=3e-2, floor=0.1):
    """``chip_smoke.worst_over_limit``: the largest |got - want| / (rtol |want|
    + row_rms x the RMS of want's row, floored at ``floor`` x the tensor's)."""
    got, want = got.float(), want.float()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    rms = rms.clamp(min=floor * float(want.pow(2).mean().sqrt()))
    return float(((got - want).abs() / (rtol * want.abs() + row_rms * rms)).max())


def bf16_kernel_model(q, k, v, lse, dout):
    """The bf16 numerics of ``csrc/flash_attention_bwd.cu`` in plain torch:
    P = 2^(s c - lse log2e) with c = scale log2e (the kernel's ex2 form),
    float32 sums of products of bf16 operands, Di = rowsum(P o dP) from the
    unrounded P, dS = P o (dP - Di) rounded to bf16 before dS.K and dS^T.Q,
    P rounded to bf16 before round(P)^T.dO; gradients stored in bf16."""
    f, b = torch.float32, torch.bfloat16
    s_len, d = q.shape[1], q.shape[2]
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=f)
    c = scale * torch.tensor(math.log2(math.e), dtype=f)
    qf, kf, vf, df = (t.to(f) for t in (q, k, v, dout))
    keep = torch.ones((s_len, s_len), dtype=torch.bool).tril()
    sc = torch.einsum("bqd,bkd->bqk", qf, kf)
    p = torch.where(keep, torch.exp2(sc * c - (lse * c / scale)[..., None]), 0.0)
    dp = torch.einsum("bqd,bkd->bqk", df, vf)
    di = (p * dp).sum(-1, keepdim=True)
    ds = (p * (dp - di)).to(b).to(f)
    dq = torch.einsum("bqk,bkd->bqd", ds, kf) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, qf) * scale
    dv = torch.einsum("bqk,bqd->bkd", p.to(b).to(f), df)
    return dq.to(b), dk.to(b), dv.to(b)


@pytest.mark.parametrize("shape", ((32, 1024, 64), (2, 200, 128), (2, 192, 256)))
def test_bf16_backward_design_rounding_fits_the_limits(shape):
    """The card kernel's bf16 design (:func:`bf16_kernel_model`) against
    autograd of the plain version on float32 copies of the same inputs,
    within chip_smoke's bf16 row-scaled limits (2e-2, 3e-2; a row's RMS
    floored at 0.1 x the tensor's); the same limits reject dk and dv with
    the keys 64..127 zeroed."""
    q, k, v, do = (rand(70 + i, *shape, dtype=torch.bfloat16) for i in range(4))
    _, lse = ops.flash_attention_lse(q, k, v, block_q=8, block_k=8)
    got = bf16_kernel_model(q, k, v, lse, do)
    want = autograd(ops.flash_attention_torch, (q.float(), k.float(), v.float()), do.float())
    worst = max(worst_over_limit(g, w) for g, w in zip(got, want))
    assert worst <= 1.0, worst
    cut = (got[0], got[1].clone(), got[2].clone())
    cut[1][:, 64:128] = 0
    cut[2][:, 64:128] = 0
    assert max(worst_over_limit(g, w) for g, w in zip(cut, want)) > 1.0


def test_no_graph_without_a_gradient():
    """Serving (no input needs a gradient, or inference mode) calls the
    plain forward wrapper: no autograd node, no log-sum-exp computed."""
    q, k, v = (rand(30 + i, 2, 128, 16) for i in range(3))
    calls = []
    real = fa_mod.flash_attention_lse
    fa_mod.flash_attention_lse = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    try:
        assert ops.FlashAttention.call(q, k, v).grad_fn is None
        with torch.inference_mode():
            qg = q.clone().requires_grad_()
        with torch.inference_mode():
            assert ops.FlashAttention.call(qg, k, v).grad_fn is None
        x = rand(1, 3, 8)
        assert ops.RMSNorm.apply(x, torch.ones(8)).grad_fn is None
        assert not calls
        out = ops.FlashAttention.call(q.requires_grad_(), k, v)
        assert out.grad_fn is not None and calls == [1]
    finally:
        fa_mod.flash_attention_lse = real


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("shape", ((5, 7, 33), (64, 2048), (1, 2050)))
def test_rmsnorm_function_matches_autograd_of_the_plain_version(shape, dtype):
    x, dy = rand(40, *shape, dtype=dtype), rand(41, *shape, dtype=dtype)
    scale = 1.0 + 0.1 * rand(42, shape[-1])
    xl, sl = x.clone().requires_grad_(), scale.clone().requires_grad_()
    y = ops.RMSNorm.apply(xl, sl, 1e-6)
    assert torch.equal(y, ops.rmsnorm(x, scale))
    got = torch.autograd.grad(y, (xl, sl), dy)
    if dtype == torch.float32:
        want = autograd(ops.rmsnorm_torch, (x, scale), dy)
    else:
        want = autograd(ops.rmsnorm_torch, (x.float(), scale), dy.float())
    close(got[:1], want[:1], dtype)
    # dscale: a float32 sum over the rows of float32 terms in both
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), atol=1e-4, rtol=1e-4)
    a, b = rms_mod.rmsnorm_bwd(x, scale, dy), rms_mod.rmsnorm_bwd(x, scale, dy)
    assert all(torch.equal(p, r) for p, r in zip(a, b))


def plain_gqa_attention(q, k, v):
    """Causal GQA attention in plain torch (no kernel wrapper): q (B, S, H,
    Dh), k/v (B, S, Hkv, Dh)."""
    b, s, h, dh = q.shape
    g = h // k.shape[2]
    kk, vv = (t.repeat_interleave(g, dim=2) for t in (k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(dh)
    logits = torch.where(torch.ones(s, s, dtype=torch.bool).tril(), logits, -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), vv)


@pytest.mark.parametrize("s", (100, 128, 200))
def test_causal_attention_gradient_with_gqa_and_padding(s):
    """The model's ``causal_attention`` (kv heads broadcast, S padded to 128)
    under autograd: dk and dv summed onto each kv head, padded rows and keys
    contributing nothing."""
    q, k, v = rand(50, 2, s, 4, 16), rand(51, 2, s, 2, 16), rand(52, 2, s, 2, 16)
    do = rand(53, 2, s, 4, 16)
    got = autograd(attn.causal_attention, (q, k, v), do)
    want = autograd(plain_gqa_attention, (q, k, v), do)
    close(got, want, torch.float32)


def test_model_rmsnorm_goes_through_the_function():
    x = rand(60, 2, 3, 32).requires_grad_()
    scale = torch.ones(32, requires_grad=True)
    y = modules.rmsnorm(scale, x)
    assert type(y.grad_fn).__name__ == "RMSNormBackward"
    dx, ds = torch.autograd.grad(y.sum(), (x, scale))
    want = autograd(ops.rmsnorm_torch, (x.detach(), scale.detach()), torch.ones(2, 3, 32))
    close((dx, ds), want, torch.float32)
