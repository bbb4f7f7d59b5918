"""K1: the device stage's elementwise affine map (``ops.affine_staged``),
a hand-written CUDA kernel beside its plain PyTorch version."""
