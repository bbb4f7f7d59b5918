"""K5: the Mamba2 SSD chunked scan (``ops.ssd``), a hand-written CUDA kernel
beside its plain PyTorch version (``ref``: ``segsum``, ``ssd_chunked``,
``ssd_decode_step``)."""
