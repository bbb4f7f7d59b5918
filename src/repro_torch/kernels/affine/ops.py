"""Public K1 wrapper (the device stage's ``affine_pallas`` kernel).

CPU buffers go to the plain :func:`~.ref.affine_staged_ref`; CUDA buffers go
to kernel K1 or raise.  ``affine_staged.LAUNCHES`` counts kernel launches, so
a run can show that its path went through the kernel.
"""
from __future__ import annotations

import torch

from .affine import affine_fwd
from .ref import Layout, affine_ref, affine_staged_ref


def affine_staged(src: torch.Tensor, layout: Layout, a, b, dst: torch.Tensor) -> torch.Tensor:
    """``o = x * a + b`` on every column of the staged batch ``src`` into the
    same places of ``dst`` (same device); returns ``dst``."""
    if src.device.type == "cpu":
        return affine_staged_ref(src, layout, a, b, dst)
    out = affine_fwd(src, layout, a, b, dst)
    affine_staged.LAUNCHES += 1
    return out


affine_staged.LAUNCHES = 0

__all__ = ["Layout", "affine_ref", "affine_staged", "affine_staged_ref"]
