"""Parameter trees from numpy into the port's tensors.

The JAX package's parameters (``np.asarray`` of each leaf) carry bf16 as
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses.  Such leaves go
through their 16-bit pattern (``view(np.uint16)`` -> ``view(torch.bfloat16)``),
which is bit-exact.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import default_device
from ..kernels.reorder.ref import ReorderState


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """One array (any numpy dtype, bf16 included) -> tensor on ``device``.

    The data is copied: the tensor never aliases the caller's (possibly
    read-only) buffer."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(default_device(device))


def params_from_numpy(tree, device=None):
    """Nested dict of numpy arrays -> the same nesting of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def reorder_state_from_numpy(buf, present, next, device=None):
    """A reorder ring as numpy arrays (``np.asarray`` of each field of the
    JAX package's ``ReorderState``; bf16 included) -> the port's
    :class:`~repro_torch.kernels.reorder.ref.ReorderState` on ``device``,
    bit for bit, so that a ring can go on in the port where JAX left it."""
    return ReorderState(
        buf=tensor_from_numpy(buf, device),
        present=tensor_from_numpy(np.asarray(present, dtype=bool), device),
        next=tensor_from_numpy(np.asarray(next, dtype=np.int32).reshape(()), device),
    )
