"""The port's LLM serving path (``repro_torch.launch.serve``,
``repro_torch.launch.steps``) held to the JAX package's on the CPU.

``serve`` of both packages gets the same parameters (the reference's,
carried across by ``convert.params_from_numpy``) and the same numpy
prompts, on the llama3.2-1B smoke config made float32 (both registries'
``get_config`` patched to return it), dense and mqr-sparse: the greedy
tokens must be equal.  Where a step's top-2 logit margin is under the
float32 tolerance of ``tests/test_torch_models.py`` a flip there would be
rounding, not a fault: the test reports such a step and compares only
the tokens before it.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.launch import serve as ref_serve
from repro.launch import steps as ref_steps
from repro.models import transformer as ref_T
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import serve as port_serve
from repro_torch.launch import steps
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
ATOL, RTOL = 1e-5, 1e-4


def _f32(get):
    def get_config(arch, smoke=False):
        return dataclasses.replace(get(arch, smoke), dtype="float32")

    return get_config


@pytest.fixture
def float32_registries(monkeypatch):
    monkeypatch.setattr(ref_registry, "get_config", _f32(ref_registry.get_config))
    monkeypatch.setattr(registry, "get_config", _f32(registry.get_config))
    ref_cfg, cfg = ref_registry.get_config("llama32_1b", True), registry.get_config("llama32_1b", True)
    params = jax.jit(lambda k: ref_T.init_params(k, ref_cfg))(jax.random.PRNGKey(0))
    return ref_cfg, cfg, params, convert.params_from_numpy(
        jax.tree.map(np.asarray, params), cfg, device=CPU)


def _near_ties(cfg, p, prompts, out, mqr_sparse):
    """Steps whose top-2 logit margin (the port's, teacher-forced on the
    reference's tokens) is under the float32 tolerance: (b, generated index)."""
    b, plen = prompts.shape
    seq = np.concatenate([prompts, out], axis=1)
    max_len = seq.shape[1]
    if mqr_sparse:
        max_len = -(-max_len // cfg.mqr_block) * cfg.mqr_block
    caches = T.init_caches(cfg, b, max_len, device=CPU)
    ties = []
    for i in range(seq.shape[1] - 1):
        logits, caches = T.decode_step(p, cfg, torch.from_numpy(seq[:, i:i + 1]), caches, i,
                                       mqr_sparse=mqr_sparse)
        if i >= plen - 1:
            top = torch.topk(logits[:, 0, :cfg.vocab_size].float(), 2).values
            margin = top[:, 0] - top[:, 1]
            ties += [(bi, i - plen + 1) for bi in range(b)
                     if float(margin[bi]) <= ATOL + RTOL * abs(float(top[bi, 0]))]
    return ties


@pytest.mark.parametrize("mqr_sparse", [False, True])
def test_serve_equals_reference_tokens(float32_registries, mqr_sparse):
    ref_cfg, cfg, ref_p, p = float32_registries
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 20)).astype(np.int32)
    kw = dict(arch="llama32_1b", smoke=True, batch=3, prompt_len=20, gen=12,
              mqr_sparse=mqr_sparse)
    want = ref_serve.serve(params=ref_p, prompts=jnp.asarray(prompts), **kw)
    got = port_serve.serve(params=p, prompts=prompts, device=CPU, **kw)
    assert got.shape == want.shape == (3, 12) and got.dtype == np.int32
    if np.array_equal(got, want):
        return
    ties = _near_ties(cfg, p, prompts, want, mqr_sparse)
    first = {}
    for bi, gi in ties:
        first.setdefault(bi, gi)
    print(f"near-tie steps (row, generated index): {ties}")
    for bi in range(3):
        upto = first.get(bi, 12) + 1  # the near-tied step itself may flip
        np.testing.assert_array_equal(got[bi, :upto], want[bi, :upto])


def test_serve_step_masks_padding_and_takes_the_first_max(monkeypatch):
    """The padded vocab ids never win; ties go to the lowest id, as
    ``jnp.argmax`` breaks them (the reference's serve step on the same
    logits)."""
    cfg = registry.get_config("llama32_1b", smoke=True)
    ref_cfg = ref_registry.get_config("llama32_1b", smoke=True)
    assert cfg.padded_vocab == cfg.vocab_size == 256
    cfg = dataclasses.replace(cfg, vocab_size=250)
    ref_cfg = dataclasses.replace(ref_cfg, vocab_size=250)
    logits = np.zeros((3, 1, 256), np.float32)
    logits[0, 0, 252] = 9.0          # a padding id: masked
    logits[0, 0, [7, 9]] = 2.0       # a tie: the first
    logits[1, 0, 249] = 1.0
    logits[2, 0, :] = -1.0           # all equal: id 0

    def fake(lg):  # a decode step that returns these logits
        return lambda *a, **k: (lg, a[3])

    monkeypatch.setattr(ref_steps.T, "decode_step", fake(jnp.asarray(logits)))
    monkeypatch.setattr(steps.T, "decode_step", fake(torch.from_numpy(logits)))
    want, _ = ref_steps.make_serve_step(ref_cfg)(None, None, {}, 0)
    got, _ = steps.make_serve_step(cfg)(None, None, {}, 0)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[:, 0], [7, 249, 0])


def test_prefill_step_equals_prefill():
    cfg = registry.get_config("llama32_1b", smoke=True)
    p = T.init_params(0, cfg, device=CPU)
    toks = torch.randint(0, cfg.vocab_size, (2, 20), generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(steps.make_prefill_step(cfg)(p, {"tokens": toks}),
                               T.prefill(p, cfg, {"tokens": toks}), rtol=0, atol=0)


def test_serve_generates():
    """tests/test_system.py's serve check, on the port."""
    out = port_serve.serve(arch="llama32_1b", smoke=True, batch=2, prompt_len=16, gen=8,
                           device=CPU)
    assert out.shape == (2, 8)


def test_serve_mqr_sparse_path():
    """tests/test_system.py's mqr-sparse serve check, on the port."""
    out = port_serve.serve(arch="llama32_1b", smoke=True, batch=1, prompt_len=16, gen=8,
                           mqr_sparse=True, device=CPU)
    assert out.shape == (1, 8)


def test_serve_audio_codebooks():
    out = port_serve.serve(arch="musicgen_large", smoke=True, batch=2, prompt_len=6, gen=4,
                           device=CPU)
    assert out.shape == (2, 4, 2)


def test_serve_and_model_raise_without_a_card(monkeypatch):
    """With no card and no explicit CPU request, nothing runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.get_config("llama32_1b", smoke=True)
    for fn in (lambda: port_serve.serve(batch=1, prompt_len=2, gen=2),
               lambda: T.init_params(0, cfg), lambda: T.init_caches(cfg, 1, 16),
               lambda: convert.params_from_numpy({}, cfg),
               lambda: port_serve.main(["--batch", "1", "--prompt-len", "2", "--gen", "2"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()


def test_cli_and_example_run_on_the_cpu(capsys):
    port_serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "4", "--gen", "3",
                     "--mqr-sparse"])
    assert "tok/s" in capsys.readouterr().out
    spec = importlib.util.spec_from_file_location(
        "serve_longcontext_torch", ROOT / "examples" / "serve_longcontext_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    dense, sparse = example.main("cpu")
    assert dense.shape == (4, 16) and sparse.shape == (2, 16)
    assert "mqr-KV touched 4/4 KV blocks" in capsys.readouterr().out
