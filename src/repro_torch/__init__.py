"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper.

The port mirrors the JAX package's tree and names (``repro_torch.models``
beside ``repro.models`` and so on) and imports nothing of it.  Its entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; there is
no silent fallback to the CPU.  Importing the package does not touch CUDA.
"""
from __future__ import annotations

import torch

__all__ = ["default_device", "have_cuda"]


def have_cuda() -> bool:
    """True when torch sees a CUDA card.  Asks NVML where it can
    (``torch.cuda.device_count``), which, unlike ``is_available``, does not
    initialise CUDA, so the caller may still fork workers that use the card."""
    return torch.cuda.device_count() > 0


def default_device(device=None) -> torch.device:
    """Resolve the device an entry point runs on.

    ``None`` means ``cuda``.  Raises ``RuntimeError`` when CUDA is asked for
    (explicitly or by default) and no card is available: a caller that wants
    the CPU says ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not have_cuda():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
