"""Public K2 wrapper, the reorder-commit (counterpart of
``repro.kernels.reorder.ops``).

CPU tensors go to the plain :func:`~.ref.commit_ref`; CUDA tensors go to
kernel K2 or raise.  ``commit.LAUNCHES`` counts kernel launches (one per
commit on the card), so a run can show that its path went through the
kernel.
"""
from __future__ import annotations

import torch

from .ref import ReorderState, commit_ref, init_state
from .reorder import LAUNCHES_PER_CALL, commit_fwd


def commit(state: ReorderState, serials: torch.Tensor, payloads: torch.Tensor, *,
           use_kernel: bool = True):
    """Batched reorder-commit: scatter K completed (serial, payload) pairs
    into the ring and emit the contiguous ready prefix in serial order.

    ``serials`` (K,) holds -1 for an empty entry; ``payloads`` is (K, W).
    Returns (new_state, emitted (S, W), emit_count () int32, accepted (K,)
    bool); rows of ``emitted`` at or past ``emit_count`` are zero.

    The commit writes ``state.buf`` and ``state.present`` in place and
    returns them in ``new_state`` (the ring is the state, and copying it
    would double a commit's bytes), so the state passed in is spent; this
    holds on both routes.  The serials of one batch must be distinct: for
    two equal serials the reference keeps one payload, the Pallas kernel
    sums them and K2 keeps either.  ``use_kernel=False`` takes the plain
    version on any device.
    """
    if not use_kernel or state.buf.device.type == "cpu":
        return commit_ref(state, serials, payloads)
    out = commit_fwd(state, serials.to(torch.int32), payloads.to(state.buf.dtype))
    commit.LAUNCHES += LAUNCHES_PER_CALL
    return out


commit.LAUNCHES = 0

__all__ = ["ReorderState", "commit", "init_state"]
