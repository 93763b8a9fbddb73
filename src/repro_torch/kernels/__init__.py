"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions and
the public wrappers (:mod:`repro_torch.kernels.ops`)."""
