# Port copy of src/repro/columnar/__init__.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""Columnar zero-copy batch subsystem + device-offload execution.

Micro-batches of fixed-width numeric tuples travel between stages as
:class:`ColumnBlock`\\ s — NumPy column vectors with per-row serials and a
ragged marker sidecar — written straight into shm ring span slots
(``TAG_COLBLOCK``) instead of round-tripping through pickle.  On top of
the block layer, ``DEVICE``-kind operators batch blocks up to device size
and dispatch them asynchronously to hand-written CUDA kernels on a side
stream, with torch-on-the-CPU and pure-NumPy backends beside them.  See
``docs/columnar.md``.

Submodules import lazily (PEP 562) so ``import repro_torch.columnar``
costs nothing until a symbol is touched, and nothing here touches CUDA
when it is imported: a process that forks device workers must not have
initialised CUDA (see :func:`~.device.cuda_fork_hazard`).
"""
from __future__ import annotations

_LAZY = {
    "Schema": ".block",
    "ColumnBlock": ".block",
    "DTYPES": ".block",
    "ColumnarCodec": ".codec",
    "encode_block": ".codec",
    "decode_block": ".codec",
    "DeviceExecutor": ".device",
    "device_op": ".device",
    "ref_apply": ".device",
    "make_kernel": ".device",
    "resolve_backend": ".device",
    "have_cuda": ".device",
    "cuda_fork_hazard": ".device",
    "KERNELS": ".device",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(_LAZY[name], __name__)
        value = getattr(mod, name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
