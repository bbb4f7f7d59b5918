"""Mamba2 mixer: the SSD (state-space duality) chunked scan
[arXiv:2405.21060] (port of ``repro.models.ssm``).

Train and prefill use the chunked SSD algorithm; decode is the O(1)-state
recurrent update.  ``segsum``, ``ssd_chunked`` and ``ssd_decode_step`` live
in ``kernels/ssd/ref.py`` (the plain version of kernel K5).

``mamba_prefill`` runs its scan through ``kernels.ssd.ops.ssd``: kernel K5 on
the card, the plain ``ssd_chunked`` in f32 on the CPU.  (The JAX package's
``mamba_prefill`` passes ``use_kernel=False``; both compute the scan from a
zero state, which is what K5 takes.)  ``mamba_train`` stays on the plain
``ssd_chunked``, the reference's default, because K5 has no backward.

Under a mesh the scan (K5, which takes raw pointers, or the plain
``ssd_chunked``) runs inside ``local_map`` on each rank's (batch, head)
shard: it is local per batch row and head (the reference constrains its
decay matrix to that layout), and DTensor's batched products refuse an
einsum whose batch dims are cut over two mesh dims.  So does the depthwise
convolution.

Shapes (one group): x (B,L,H,P), dt (B,L,H), A (H,), B and C (B,L,N);
state (B,H,P,N).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssd.ops import ssd
from ..kernels.ssd.ref import ssd_chunked, ssd_decode_step
from ..sharding.context import get_mesh, local_apply, logical_spec, shard
from ..sharding.spec import P
from .common import ModelConfig, apply_norm, inner_norm


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    Din, N = cfg.d_inner, cfg.ssm_state
    # layout: [z (Din) | x (Din) | B (N) | C (N) | dt (H)]
    z, xBC, dt = torch.split(zxbcdt, [Din, Din + 2 * N, cfg.ssm_heads], dim=-1)
    return z, xBC, dt


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d, then SiLU.  xBC (B,L,Cd), w (K,Cd): one
    grouped convolution (a cross-correlation, as ``conv_general_dilated``)
    over the input left-padded with K-1 zeros.  Under a mesh it runs inside
    ``local_apply`` (DTensor's convolution rule does not split the groups of
    a depthwise convolution): batch over the DP dims, channels over 'model'."""
    b_, c = logical_spec(get_mesh(), (xBC.shape[0], xBC.shape[2]), ("dp", "tp"))
    return local_apply(_conv, (xBC, w, b), (P(b_, None, c), P(None, c), P(c)), P(b_, None, c))


def _conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    K, Cd = w.shape
    out = F.conv1d(F.pad(xBC.transpose(1, 2), (K - 1, 0)), w.t()[:, None, :], groups=Cd)
    return F.silu(out.transpose(1, 2) + b[None, None, :])


def _pad_len(L: int, chunk: int) -> int:
    return (chunk - L % chunk) % chunk


def _local_scan(fn, xh, dt, A, Bm, Cm):
    """``fn(xh, dt, A, Bm, Cm) -> (y, hT)``; under a mesh inside
    ``local_apply``, batch over the DP dims and heads over 'model' where
    they divide: the scan is local per batch row and head."""
    b, h = logical_spec(get_mesh(), (xh.shape[0], xh.shape[2]), ("dp", "tp"))
    return local_apply(fn, (xh, dt, A, Bm, Cm),
                       (P(b, None, h, None), P(b, None, h), P(h), P(b, None, None),
                        P(b, None, None)),
                       (P(b, None, h, None), P(b, h, None, None)))


def _run_ssd(cfg: ModelConfig, xh, dt, A, Bm, Cm, use_kernel: bool):
    """Pads L to a chunk multiple with dt=0 (identity steps: no decay, no
    input) so the final state is exact, scans, then truncates the output;
    under a mesh all three on each rank's piece.  With ``use_kernel`` the
    scan goes through ``ops.ssd`` (K5 on the card), which takes contiguous
    f32 inputs."""
    L = xh.shape[1]
    pad = _pad_len(L, cfg.ssm_chunk)

    def scan(xh, dt, A, Bm, Cm):
        if pad:
            xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
            dt = F.pad(dt, (0, 0, 0, pad))
            Bm = F.pad(Bm, (0, 0, 0, pad))
            Cm = F.pad(Cm, (0, 0, 0, pad))
        if use_kernel:  # K5 on the card, which takes contiguous inputs
            y, hT = ssd(*(t.contiguous() for t in (xh, dt, A, Bm, Cm)), chunk=cfg.ssm_chunk)
        else:
            y, hT = ssd_chunked(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
        return y[:, :L], hT

    return _local_scan(scan, xh, dt, A, Bm, Cm)


def _mix(cfg: ModelConfig, p: dict, xres: torch.Tensor, use_kernel: bool):
    """The block over a whole sequence: (residual output, final ssm state,
    the pre-conv inputs xBC)."""
    B, L, _ = xres.shape
    Din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    h = apply_norm(cfg, xres, p, "norm")
    zxbcdt = h @ p["in_proj"]
    if not use_kernel:  # the reference constrains mamba_train's projection only
        zxbcdt = shard(zxbcdt, "dp", None, "tp")
    z, xBC_raw, dt = _split_proj(cfg, zxbcdt)
    xBC = _causal_conv(xBC_raw, p["conv_w"], p["conv_b"])
    xs, Bm, Cm = torch.split(xBC, [Din, N, N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"].float())
    xh = xs.reshape(B, L, H, P).float()
    y, hT = _run_ssd(cfg, xh, dt, A, Bm.float(), Cm.float(), use_kernel)
    y = y + xh * p["ssm_D"][None, None, :, None]
    y = y.reshape(B, L, Din).to(xres.dtype)
    y = inner_norm(y * F.silu(z), p, "gate_norm")
    return xres + (y @ p["out_proj"]).to(xres.dtype), hT, xBC_raw


def mamba_train(cfg: ModelConfig, p: dict, xres: torch.Tensor) -> torch.Tensor:
    """Full-sequence mamba2 block (train). Returns the residual output."""
    return _mix(cfg, p, xres, use_kernel=False)[0]


def mamba_prefill(cfg: ModelConfig, p: dict, xres: torch.Tensor):
    """Like ``mamba_train``, through K5 on the card; also returns the
    (ssm_state (B,H,P,N) f32, conv_state (B,K-1,Cd)) caches."""
    y, hT, xBC_raw = _mix(cfg, p, xres, use_kernel=True)
    conv_state = xBC_raw[:, -(cfg.ssm_conv_kernel - 1):, :]  # last K-1 pre-conv inputs
    return y, (hT, conv_state)


def mamba_decode(
    cfg: ModelConfig,
    p: dict,
    xres: torch.Tensor,  # (B, 1, D)
    cache: tuple[torch.Tensor, torch.Tensor],  # (ssm_state (B,H,P,N), conv_state (B,K-1,Cd))
):
    """One token; returns (y, (new ssm_state, new conv_state)).  The caller
    decides whether the new states replace the old ones in place."""
    B = xres.shape[0]
    Din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    ssm_state, conv_state = cache
    h = apply_norm(cfg, xres, p, "norm")
    z, xBC_new, dt = _split_proj(cfg, h @ p["in_proj"])  # each (B, 1, ...)
    # roll the conv state, apply the conv at the last position
    window = torch.cat([conv_state, xBC_new], dim=1)  # (B, K, Cd)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    xs, Bm, Cm = torch.split(F.silu(conv_out), [Din, N, N], dim=-1)
    dtv = F.softplus(dt[:, 0, :].float() + p["dt_bias"][None, :])
    A = -torch.exp(p["A_log"].float())
    xh = xs.reshape(B, H, P).float()
    y, h_new = ssd_decode_step(xh, dtv, A, Bm.float(), Cm.float(), ssm_state)
    y = y + xh * p["ssm_D"][None, :, None]
    y = y.reshape(B, 1, Din).to(xres.dtype)
    y = inner_norm(y * F.silu(z), p, "gate_norm")
    return xres + (y @ p["out_proj"]).to(xres.dtype), (h_new, window[:, 1:, :])
