"""Plain PyTorch version of K5, the Mamba2 SSD chunked scan
[arXiv:2405.21060]: the counterpart of ``segsum``, ``ssd_chunked`` and
``ssd_decode_step`` in ``repro.models.ssm``.

Shapes (one group): x (B,L,H,P), dt (B,L,H) after softplus, A (H,) negative,
B and C (B,L,N); the state is (B,H,P,N).  Each contraction is a
two-operand einsum with the elementwise scalings applied first, as in the
reference.  Types follow torch's promotion as the reference follows jnp's:
a bf16 ``x`` meets the f32 ``dt`` in ``x * dt`` and the rest runs in f32.
"""
from __future__ import annotations

import torch


def segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} x[..., k] for
    j <= i, -inf above the diagonal (the 1-SS 'attention' log-decay matrix)."""
    L = x.shape[-1]
    c = torch.cumsum(x, dim=-1)
    diff = c[..., :, None] - c[..., None, :]
    mask = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int = 256, h0=None):
    """Returns (y (B,L,H,P), final_state (B,H,P,N))."""
    B_, L, H, P = x.shape
    N = Bm.shape[-1]
    nc = L // chunk
    if nc * chunk != L:
        raise ValueError(f"seq len {L} must be a multiple of chunk {chunk}")

    xc = x.reshape(B_, nc, chunk, H, P)
    dtc = dt.reshape(B_, nc, chunk, H)
    Bc = Bm.reshape(B_, nc, chunk, N)
    Cc = Cm.reshape(B_, nc, chunk, N)

    dA = dtc * A[None, None, None, :]  # (B,nc,cl,H)
    dA_cum = torch.cumsum(dA, dim=2)  # within-chunk cumulative log-decay
    xdt = xc * dtc[..., None]  # (B,nc,cl,H,P)

    # ---- intra-chunk (quadratic, the "attention-like" term)
    Ldec = torch.exp(segsum(dA.permute(0, 1, 3, 2)))  # (B,nc,H,cl,cl)
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)  # (B,nc,cl,cl)
    M = Ldec * scores[:, :, None]  # (B,nc,H,cl,cl)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", M, xdt)

    # ---- chunk summaries: state contributed by each chunk
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)  # (B,nc,cl,H)
    S = torch.einsum("bckn,bckhp->bchpn", Bc, xdt * decay_to_end[..., None])

    # ---- inter-chunk recurrence over the chunk index
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])  # (B,nc,H)
    h = torch.zeros((B_, H, P, N), dtype=x.dtype, device=x.device) if h0 is None else h0
    h_before = []
    for c in range(nc):
        h_before.append(h)  # the state BEFORE this chunk
        h = h * chunk_decay[:, c, :, None, None] + S[:, c]
    h_before = torch.stack([hb.to(S.dtype) for hb in h_before], dim=1)  # (B,nc,H,P,N)

    # ---- inter-chunk output: y += C_q . h_before * exp(dA_cum_q)
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cc, h_before)
    y_inter = y_inter * torch.exp(dA_cum)[..., None]
    y = (y_intra + y_inter).reshape(B_, L, H, P)
    return y, h


def ssd_decode_step(x, dt, A, Bm, Cm, h):
    """One recurrent step: x (B,H,P), dt (B,H), A (H,), B and C (B,N),
    h (B,H,P,N).  Returns (y (B,H,P), h_new)."""
    dA = torch.exp(dt * A[None, :])  # (B,H)
    h_new = h * dA[..., None, None] + torch.einsum("bn,bh,bhp->bhpn", Bm, dt, x)
    y = torch.einsum("bn,bhpn->bhp", Cm, h_new)
    return y, h_new


def ssd_scan_ref(x, dt, A, Bm, Cm, chunk: int = 128):
    """The function K5 computes: :func:`ssd_chunked` from a zero state in
    f32, with ``y`` returned in ``x``'s dtype and the final state in f32."""
    y, hT = ssd_chunked(x.float(), dt.float(), A.float(), Bm.float(), Cm.float(), chunk)
    return y.to(x.dtype), hT
