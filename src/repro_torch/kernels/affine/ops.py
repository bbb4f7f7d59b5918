"""Public K1 wrapper (the device stage's ``affine_pallas`` kernel).

The route follows the device the caller names, not where the buffers lie:
``device="cuda"`` launches kernel K1 on buffers in the card's memory or in
pinned host memory (the device stage's staging buffers), or raises;
``device="cpu"`` runs the plain :func:`~.ref.affine_staged_ref` on host
buffers, and raises on a buffer that lies on a card.  Nothing falls back.
``affine_staged.LAUNCHES`` counts kernel launches, so a run can show that its
path went through the kernel.
"""
from __future__ import annotations

import torch

from .affine import affine_fwd
from .ref import Layout, affine_ref, affine_staged_ref


def affine_staged(src: torch.Tensor, layout: Layout, a, b, dst: torch.Tensor, *,
                  device, events=None) -> torch.Tensor:
    """``o = x * a + b`` on every column of the staged batch ``src`` into the
    same places of ``dst``, on ``device`` (``cuda``: K1; ``cpu``: the plain
    version); returns ``dst``.  On the card, ``events`` (two timing events)
    are recorded right before and after the launch
    (:func:`~.affine.affine_fwd`)."""
    device = torch.device(device)
    if device.type == "cpu":
        if src.is_cuda or dst.is_cuda:
            raise ValueError(f"device='cpu' runs the plain version on host buffers; src is "
                             f"on {src.device}, dst on {dst.device}")
        return affine_staged_ref(src, layout, a, b, dst)
    out = affine_fwd(src, layout, a, b, dst, device, events)
    affine_staged.LAUNCHES += 1
    return out


affine_staged.LAUNCHES = 0

__all__ = ["Layout", "affine_ref", "affine_staged", "affine_staged_ref"]
