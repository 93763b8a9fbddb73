"""Training driver: data pipeline -> train step -> checkpoint/restart,
straggler monitoring, failure injection, optional EF-int8 grad compression.

Counterpart of ``repro.launch.train`` on one device: the card unless
``device="cpu"`` (``--device cpu``).  On the card every RMSNorm and causal
attention runs kernels #10 and #8 forward and backward.

  python -m repro_torch.launch.train --full --steps 10 --batch 8 --seq 1024
  python -m repro_torch.launch.train --device cpu --steps 200 --batch 8 --seq 128 \\
      --ckpt-dir build/ckpt
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.ft import FailureInjector, StragglerMonitor
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch import steps as step_lib
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.optim.compress import ef_int8_state


def to_device(batch: dict, device) -> dict:
    """A numpy batch of the data pipeline as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def train(
    arch: str = "llama32_1b",
    smoke: bool = True,
    steps: int = 100,
    batch: int = 8,
    seq: int = 128,
    lr: float = 1e-3,
    ckpt_dir: str = "",
    ckpt_every: int = 50,
    log_every: int = 10,
    grad_compress: bool = False,
    fail_at_step: int = -1,
    seed: int = 0,
    d_model: int = 0,
    n_layers: int = 0,
    device=None,
):
    """Train ``arch`` on the synthetic pipeline; returns the losses of the
    steps run (from the resumed step on) as a numpy array."""
    dev = resolve_device(device)
    cfg = registry.get_config(arch, smoke=smoke)
    overrides = {}
    if d_model:
        overrides["d_model"] = d_model
    if n_layers:
        overrides["n_layers"] = n_layers
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    opt_cfg = AdamWConfig(lr=lr, warmup_steps=min(20, steps // 5 + 1), total_steps=steps)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=seed))
    train_step = step_lib.make_train_step(cfg, opt_cfg, grad_compress=grad_compress)

    mgr = CheckpointManager(ckpt_dir, keep=2) if ckpt_dir else None
    injector = FailureInjector(fail_at_step if fail_at_step >= 0 else None)
    monitor = StragglerMonitor()

    start = 0
    params = T.init_params(seed, cfg, device=dev)
    opt_state = adamw.init_state(params, opt_cfg)
    ef = ef_int8_state(params) if grad_compress else None
    if mgr is not None and mgr.latest_step() is not None:
        start = mgr.latest_step()
        state = mgr.restore(start, {"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        print(f"[resume] restored step {start} from {ckpt_dir}")

    losses = []
    try:
        for step in range(start, steps):
            injector.maybe_fail(step)
            t0 = time.time()
            b = to_device(data.batch(step), dev)
            if grad_compress:
                params, opt_state, ef, metrics = train_step(params, opt_state, b, ef)
            else:
                params, opt_state, metrics = train_step(params, opt_state, b)
            loss = float(metrics["loss"])
            losses.append(loss)
            monitor.observe(step, time.time() - t0)
            if log_every and step % log_every == 0:
                print(
                    f"step {step:5d} loss {loss:7.4f} "
                    f"gnorm {float(metrics['grad_norm']):8.3f} "
                    f"lr {float(metrics['lr']):.2e} ({time.time()-t0:.2f}s)"
                )
            if mgr is not None and ckpt_every and (step + 1) % ckpt_every == 0:
                mgr.save(step + 1, {"params": params, "opt": opt_state}, {"loss": loss})
    finally:  # a failure still lets the last save publish before it propagates
        if mgr is not None:
            mgr.wait()
    if mgr is not None:
        mgr.save(steps, {"params": params, "opt": opt_state},
                 {"loss": losses[-1] if losses else float("nan")})
        mgr.wait()
    if monitor.events:
        print(f"[stragglers] {len(monitor.events)} flagged steps")
    return np.array(losses)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama32_1b")
    ap.add_argument("--full", action="store_true", help="full (non-smoke) config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--fail-at-step", type=int, default=-1)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--n-layers", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    train(
        arch=args.arch, smoke=not args.full, steps=args.steps,
        batch=args.batch, seq=args.seq, lr=args.lr, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, log_every=args.log_every,
        grad_compress=args.grad_compress, fail_at_step=args.fail_at_step,
        d_model=args.d_model, n_layers=args.n_layers, seed=args.seed, device=args.device,
    )


if __name__ == "__main__":
    main()
