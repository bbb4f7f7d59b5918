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
