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
reference scatter-adds them.)

Under a mesh the tokens are split into R rows, R = the DP shard count
(pod x data) where it divides the tokens, as in the JAX package (R = 1
without a mesh): each row routes its Tl = T/R tokens with its own capacity,
so which assignments are dropped depends on the mesh.  The dispatch and the
combine run per row inside ``local_map`` (``local_apply``) over the DP dims
(the reference's ``shard_map``): each DP rank holds one row and calls the
same one-row K3 on it.  ``moe_ep`` keeps one row and shards the expert buffers over DP.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.dispatch.ops import dispatch
from ..sharding.context import get_mesh, local_apply, shard
from ..sharding.partitioning import axis_size, dp_axes
from ..sharding.spec import P
from .common import ModelConfig, apply_norm


def _act(cfg: ModelConfig, up: torch.Tensor, gate) -> torch.Tensor:
    if cfg.ffn_act == "swiglu":
        return F.silu(gate) * up
    return F.gelu(up, approximate="tanh")  # jax.nn.gelu's default


def mlp(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = apply_norm(cfg, x, p, "ffn_norm")
    up = shard(h @ p["w_up"], "dp", None, "tp")  # d_ff over 'model' (Megatron TP)
    gate = shard(h @ p["w_gate"], "dp", None, "tp") if "w_gate" in p else None
    return x + (_act(cfg, up, gate) @ p["w_down"]).to(x.dtype)


# ----------------------------------------------------------------- MoE
def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens (at least 4)."""
    return max(int(math.ceil(tokens * cfg.top_k / cfg.num_experts * cfg.capacity_factor)), 4)


def _num_rows(mesh, tokens: int) -> int:
    """R = the product of the mesh's DP dims (pod, data) where it divides
    ``tokens``, else 1; 1 without a mesh."""
    if mesh is None:
        return 1
    r = 1
    for a in ("pod", "data"):
        if a in mesh.mesh_dim_names:
            r *= axis_size(mesh, a)
    return r if tokens % r == 0 else 1


def _combine(out_flat, dest, top_v, k: int):
    """A token's output: its k assignments' expert rows, each weighted by
    its gate (zero where dropped), summed in a fixed order (a token's k
    assignments are adjacent rows).  out_flat (E*C, D), dest (T*k,), top_v
    (T, k) -> (T, D)."""
    keep = dest >= 0
    combine = top_v.reshape(-1).to(out_flat.dtype)
    pa = out_flat[dest.clamp(min=0).long()] * keep[:, None].to(out_flat.dtype) * combine[:, None]
    # (a scatter-add, index_add_, adds with atomics on the card, in an order
    # that changes from run to run)
    return pa.reshape(-1, k, out_flat.shape[-1]).sum(dim=1)


def moe(cfg: ModelConfig, p: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (residual output, load-balancing aux loss).  The tokens are
    cut into R rows (R = 1 without a mesh or with ``moe_ep``), each routed
    with its own capacity: the JAX package's row layout."""
    mesh = get_mesh()
    B, S, D = x.shape
    T = B * S
    E, k = cfg.num_experts, cfg.top_k
    R = 1 if cfg.moe_ep else _num_rows(mesh, T)
    Tl = T // R
    # batch over the DP dims before the rows are cut: a stream left S-sharded
    # over 'model' would cut them in a strided layout DTensor's views refuse
    h_all = shard(apply_norm(cfg, x, p, "ffn_norm"), "dp", None, None).reshape(T, D)
    h = shard(h_all.reshape(R, Tl, D), "dp", None, None)

    # the router whole on every rank (its d_model dim is FSDP-cut over 'data',
    # which the rows hold): gates and their gradient keep the rows' layout
    router = shard(p["w_router"], None, None)
    gates = torch.softmax(h.float() @ router, dim=-1)  # (R, Tl, E), router in f32
    gates = shard(gates, "dp", None, None)  # and their gradient, whatever reaches it
    top_v, top_i = torch.topk(gates, k, dim=-1)  # (R, Tl, k), largest first
    top_v = top_v / top_v.sum(-1, keepdim=True).clamp(min=1e-9)
    ids = top_i.reshape(R, Tl * k).to(torch.int32)
    capacity = moe_capacity(cfg, Tl)

    # each row's dispatch and combine on the rank that holds it: rows over
    # the DP dims when there are R > 1 of them, else one row on every rank
    rows = lambda nd: P(dp_axes(mesh) if R > 1 else None, *([None] * (nd - 1)))

    def _dispatch(ids_r, h_r):
        # (E, C, D) a row: K3 on the card, which reads assignment t's row
        # h[t // k] itself (group=k), so no gathered copy of h is made
        outs = [dispatch(i.contiguous(), hr.contiguous(), E, capacity, group=k)
                for i, hr in zip(ids_r, h_r)]
        return (torch.stack([o[0] for o in outs]), torch.stack([o[2] for o in outs]),
                torch.stack([o[1] for o in outs]))

    def _gather_combine(f_r, d_r, v_r):
        return torch.stack([_combine(f, d, v, k) for f, d, v in zip(f_r, d_r, v_r)])

    buf, dest, counts = local_apply(_dispatch, (ids, h), (rows(2), rows(3)),
                                    (rows(4), rows(2), rows(2)))

    # aux load-balance loss (Switch-style): E * sum_e f_e * P_e, the
    # assignment counts per row (before the capacity clamp) averaged over rows
    me = gates.mean(dim=(0, 1))
    ce = counts.float().mean(0) / (Tl * k)
    aux = E * torch.sum(me * ce)

    buf = buf.reshape(R, E, capacity, D)
    dp = None if cfg.moe_ep else "dp"
    ep = "dp" if cfg.moe_ep else None
    buf = shard(buf, dp, ep, None, None)
    # the expert weights gathered over 'data' (FSDP) unless experts live there
    w_up, w_gate, w_down = p["we_up"], p["we_gate"], p["we_down"]
    if not cfg.moe_ep:
        w_up, w_gate = (shard(w, None, None, "tp") for w in (w_up, w_gate))
        w_down = shard(w_down, None, "tp", None)
    up = shard(torch.einsum("recd,edf->recf", buf, w_up), dp, ep, None, "tp")
    gate = shard(torch.einsum("recd,edf->recf", buf, w_gate), dp, ep, None, "tp")
    down = torch.einsum("recf,efd->recd", F.silu(gate) * up, w_down)
    # experts whole before they merge with the slots (E rarely splits evenly)
    down = shard(down, dp, None, None, None)
    out_flat = shard(down.reshape(R, E * capacity, D), dp, None, None)

    y = local_apply(_gather_combine, (out_flat, dest, top_v), (rows(3), rows(2), rows(3)),
                    rows(3))
    y = shard(y, "dp", None, None).reshape(T, D)

    if cfg.num_shared_experts:
        y = y + (F.silu(h_all @ p["ws_gate"]) * (h_all @ p["ws_up"])) @ p["ws_down"]
    return x + y.reshape(B, S, D).to(x.dtype), aux


def apply_ffn(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor):
    """Uniform interface: returns (y, aux); aux is zero but for ``moe``."""
    if kind == "mlp":
        return mlp(cfg, p, x), torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "moe":
        return moe(cfg, p, x)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)  # "none"
