"""Host-side ordering primitives of the port (copies of ``repro.core``'s
JAX-free ``serial`` and ``reorder`` modules)."""
from .reorder import (
    LockBasedReorderBuffer,
    NonBlockingReorderBuffer,
    ParkingReorderBuffer,
    ReorderBuffer,
    make_reorder_buffer,
)
from .serial import AtomicFlag, AtomicLong, SerialAssigner

__all__ = [
    "AtomicFlag",
    "AtomicLong",
    "LockBasedReorderBuffer",
    "NonBlockingReorderBuffer",
    "ParkingReorderBuffer",
    "ReorderBuffer",
    "SerialAssigner",
    "make_reorder_buffer",
]
