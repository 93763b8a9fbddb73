"""Serving driver: batched greedy decoding with KV caches; the long-context
path uses the mqr-KV sparse attention (the paper's technique).

Counterpart of ``repro.launch.serve``, on the card unless ``device="cpu"``
(``--device cpu``) is asked for:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama32_1b \\
      [--full] [--mqr-sparse] --batch 4 --prompt-len 32 --gen 32

NOT the spatial serving front end: this module serves transformer tokens.
Spatial query serving is :mod:`repro_torch.serve` over
:mod:`repro_torch.launch.spatial_serve`.

The prompt streams through decode steps, which build the caches, as in the
reference.  The loop reads nothing on the host: each step's tokens feed
the next on the device, and all tokens come to the host once, at the end.
Without ``prompts`` the prompts are drawn from ``seed + 1`` with a
``torch.Generator``, and without ``params`` the weights from ``seed``:
neither gives the reference's bits, so to compare the two packages pass
both (``convert.params_from_numpy``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch import steps as step_lib
from repro_torch.models import transformer as T


def serve(
    arch: str = "llama32_1b",
    smoke: bool = True,
    batch: int = 4,
    prompt_len: int = 32,
    gen: int = 32,
    mqr_sparse: bool = False,
    seed: int = 0,
    params=None,
    prompts=None,
    device=None,
    cfg=None,
):
    """Greedy generation of ``gen`` tokens after a ``prompt_len`` prompt for
    ``batch`` sequences; returns the generated tokens as numpy, (batch, gen)
    ((batch, gen, K) for audio).  ``cfg`` replaces the registry's config of
    ``arch`` (a model cut in depth)."""
    dev = resolve_device(device)
    cfg = cfg or registry.get_config(arch, smoke=smoke)
    if params is None:
        params = T.init_params(seed, cfg, device=dev)
    max_len = prompt_len + gen
    if cfg.mqr_block and mqr_sparse:
        max_len = ((max_len + cfg.mqr_block - 1) // cfg.mqr_block) * cfg.mqr_block
    if prompts is None:
        shape = ((batch, prompt_len, cfg.n_codebooks) if cfg.frontend == "audio_codebooks"
                 else (batch, prompt_len))
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        prompts = torch.randint(0, cfg.vocab_size, shape, generator=g, device=dev,
                                dtype=torch.int32)
    if not isinstance(prompts, torch.Tensor):
        prompts = torch.from_numpy(np.asarray(prompts))
    prompts = prompts.to(device=dev, dtype=torch.int32)

    serve_step = step_lib.make_serve_step(cfg, mqr_sparse=mqr_sparse)
    with torch.inference_mode():
        caches = T.init_caches(cfg, batch, max_len, device=dev)
        t0 = time.perf_counter()
        for t in range(prompt_len):
            nxt, caches = serve_step(params, prompts[:, t:t + 1], caches, t)
        generated = [nxt]
        for t in range(prompt_len, prompt_len + gen - 1):
            nxt, caches = serve_step(params, generated[-1], caches, t)
            generated.append(nxt)
        out = torch.cat(generated, dim=1).cpu().numpy()  # the one host read
    dt = time.perf_counter() - t0
    n_tok = batch * (prompt_len + gen)
    print(
        f"[serve] {arch} batch={batch} prompt={prompt_len} gen={gen} "
        f"mqr_sparse={mqr_sparse} device={dev}: {n_tok / dt:.1f} tok/s ({dt:.2f}s)"
    )
    if not ((out >= 0).all() and (out < cfg.vocab_size).all()):
        raise RuntimeError("a generated token lies outside the vocabulary")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama32_1b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--mqr-sparse", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    serve(
        arch=args.arch, smoke=not args.full, batch=args.batch,
        prompt_len=args.prompt_len, gen=args.gen, mqr_sparse=args.mqr_sparse,
        seed=args.seed, device=args.device,
    )


if __name__ == "__main__":
    main()
