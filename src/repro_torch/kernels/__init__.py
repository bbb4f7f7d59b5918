"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``affine``: K1, the device stage's affine map; ``reorder``: K2, the
batched reorder-commit; ``dispatch``: K3, the hybrid-queue dispatch;
``attention``: K4, flash-attention forward; ``ssd``: K5, the Mamba2 SSD
chunked scan)."""
