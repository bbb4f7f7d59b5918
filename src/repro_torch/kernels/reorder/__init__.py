"""K2: the paper's batched reorder-commit (``ops.commit``), a hand-written
CUDA kernel beside its plain PyTorch version."""
