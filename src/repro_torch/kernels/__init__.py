"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``attention``: K4, flash-attention forward)."""
