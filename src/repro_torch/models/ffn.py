"""Dense MLP and Mixture-of-Experts feed-forward layers (port of
``repro.models.ffn``).

The MoE dispatch is the paper's hybrid queue (§4.3): each (token, choice)
assignment is routed to its expert in arrival order (token-major, choice
minor) with a per-expert capacity, through ``kernels.dispatch.ops.dispatch``:
kernel K3 on the card, the plain ``dispatch_ref`` on the CPU.  Both take the
token rows with ``group=k`` (assignment t is row t // k), and K3 reads each
assignment's row itself, where the JAX package first gathers the rows
(``h[token_of]``); the buffers are the same.  (The JAX
package ranks with a stable sort in ``moe_dispatch_rowwise``; both keep
arrival order within an expert, so the same assignments are dropped.  K3
marks a dropped assignment -1 where the reference uses ``E*C``, and the
combine sums each token's k expert outputs in a fixed order where the
reference scatter-adds them.)  The JAX
package's row layout and ``shard_map`` serve data-parallel meshes and its
``moe_ep`` branch expert parallelism; on one device both compute what
``moe`` below computes with one row.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.dispatch.ops import dispatch
from .common import ModelConfig, apply_norm


def _act(cfg: ModelConfig, up: torch.Tensor, gate) -> torch.Tensor:
    if cfg.ffn_act == "swiglu":
        return F.silu(gate) * up
    return F.gelu(up, approximate="tanh")  # jax.nn.gelu's default


def mlp(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = apply_norm(cfg, x, p, "ffn_norm")
    up = h @ p["w_up"]
    gate = h @ p["w_gate"] if "w_gate" in p else None
    return x + (_act(cfg, up, gate) @ p["w_down"]).to(x.dtype)


# ----------------------------------------------------------------- MoE
def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens (at least 4)."""
    return max(int(math.ceil(tokens * cfg.top_k / cfg.num_experts * cfg.capacity_factor)), 4)


def moe(cfg: ModelConfig, p: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (residual output, load-balancing aux loss)."""
    B, S, D = x.shape
    T = B * S
    E, k = cfg.num_experts, cfg.top_k
    h = apply_norm(cfg, x, p, "ffn_norm").reshape(T, D)

    gates = torch.softmax(h.float() @ p["w_router"], dim=-1)  # (T, E), router in f32
    top_v, top_i = torch.topk(gates, k, dim=-1)  # (T, k), largest first
    top_v = top_v / top_v.sum(-1, keepdim=True).clamp(min=1e-9)

    # aux load-balance loss (Switch-style): E * sum_e f_e * P_e
    ids = top_i.reshape(T * k).to(torch.int32)
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, ids, torch.ones(T * k, dtype=torch.float32, device=x.device)) / (T * k)
    aux = E * torch.sum(gates.mean(0) * ce)

    capacity = moe_capacity(cfg, T)
    # (E, C, D): K3 on the card, which reads assignment t's row h[t // k]
    # itself (group=k), so no gathered copy of h is made
    buf, _, dest = dispatch(ids, h, E, capacity, group=k)
    up = torch.bmm(buf, p["we_up"])
    gate = torch.bmm(buf, p["we_gate"])
    out_flat = torch.bmm(F.silu(gate) * up, p["we_down"]).reshape(E * capacity, D)

    keep = dest >= 0
    combine = top_v.reshape(T * k).to(x.dtype)
    pa = out_flat[dest.clamp(min=0).long()] * keep[:, None].to(x.dtype) * combine[:, None]
    # a token's k assignments are adjacent rows: sum them in a fixed order
    # (a scatter-add, index_add_, adds with atomics on the card, in an order
    # that changes from run to run)
    y = pa.reshape(T, k, D).sum(dim=1)

    if cfg.num_shared_experts:
        y = y + (F.silu(h @ p["ws_gate"]) * (h @ p["ws_up"])) @ p["ws_down"]
    return x + y.reshape(B, S, D).to(x.dtype), aux


def apply_ffn(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor):
    """Uniform interface: returns (y, aux); aux is zero but for ``moe``."""
    if kind == "mlp":
        return mlp(cfg, p, x), torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "moe":
        return moe(cfg, p, x)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)  # "none"
