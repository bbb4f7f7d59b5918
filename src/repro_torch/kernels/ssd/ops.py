"""Public K5 wrapper, the SSD chunked scan (counterpart of
``repro.kernels.ssd.ops``).

CPU tensors go to the plain :func:`~.ref.ssd_scan_ref`; CUDA tensors go to
kernel K5 or raise.  ``ssd.LAUNCHES`` counts CUDA launches
(:data:`~.ssd.LAUNCHES_PER_CALL` a call), so a run can show that its path
went through the kernel.
"""
from __future__ import annotations

from .ref import ssd_scan_ref
from .ssd import LAUNCHES_PER_CALL, ssd_fwd


def ssd(x, dt, A, Bm, Cm, *, chunk: int = 128, h0=None):
    """Mamba2 SSD over (B, L, H, P) from a zero state.  Returns (y in x's
    dtype, final_state (B, H, P, N) float32).  ``h0`` is not taken, as in
    the reference's kernel path (a state carried in goes through
    :func:`~.ref.ssd_chunked`); passing one raises."""
    if h0 is not None:
        raise ValueError("the kernel path starts from zero state; h0 must be None")
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, Bm, Cm, chunk)
    out = ssd_fwd(x, dt, A, Bm, Cm, chunk)
    ssd.LAUNCHES += LAUNCHES_PER_CALL
    return out


ssd.LAUNCHES = 0

__all__ = ["ssd"]
