"""End-to-end training driver of the PyTorch port (counterpart of
``examples/train_lm.py``): a llama-style model on the synthetic pipeline
with checkpoint/resume and straggler monitoring, on the CUDA card (kernels
#8 and #10 forward and backward) unless ``--device cpu``.

Full run (a ~100M-parameter model, 12 layers of d_model 768):
  PYTHONPATH=src python examples/train_lm_torch.py --steps 300

Quick demo (2 layers of d_model 512, ~25M parameters):
  PYTHONPATH=src python examples/train_lm_torch.py --quick [--device cpu]

Checkpoints go to a fresh temporary folder (under ``$TMPDIR``) that is
removed at the end; ``--ckpt-dir DIR`` keeps them in DIR instead, and a run
with the same DIR resumes from its newest step.
"""
import argparse
import sys
import tempfile

sys.path.insert(0, "src")

from repro_torch.launch.train import train  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--ckpt-dir", default="",
                    help="keep checkpoints here and resume from them (default: a "
                         "temporary folder removed at the end)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.ckpt_dir:
        return run(args, args.ckpt_dir)
    with tempfile.TemporaryDirectory(prefix="train_lm_torch_") as tmp:
        return run(args, tmp)


def run(args, ckpt_dir: str):
    if args.quick:
        # ~25M params: d_model=512, 2 layers, 128k vocab head dominates
        losses = train(arch="llama32_1b", smoke=True, steps=60, batch=8,
                       seq=128, d_model=512, n_layers=2, lr=1e-3,
                       ckpt_dir=ckpt_dir, ckpt_every=25, log_every=5,
                       device=args.device)
    else:
        # ~100M params: d_model=768, 12 layers (llama3-style stack)
        losses = train(arch="llama32_1b", smoke=True, steps=args.steps,
                       batch=16, seq=256, d_model=768, n_layers=12, lr=6e-4,
                       ckpt_dir=ckpt_dir, ckpt_every=50, log_every=10,
                       device=args.device)
    if len(losses) == 0:
        print(f"nothing to run: {ckpt_dir} already holds the last step")
    else:
        print(f"final loss {losses[-5:].mean():.4f} (start {losses[:5].mean():.4f})")
    return losses


if __name__ == "__main__":
    main()
