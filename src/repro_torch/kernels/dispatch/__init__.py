"""K3: the paper's hybrid-queue dispatch (``ops.dispatch``), a hand-written
CUDA kernel beside its plain PyTorch version."""
