"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``affine``: K1, the device stage's affine map; ``attention``: K4,
flash-attention forward)."""
