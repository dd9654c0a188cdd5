"""The port's kernels (hand-written for Hopper, built from ``csrc/``), each
beside its plain PyTorch twin, plus the device-side preprocess."""
