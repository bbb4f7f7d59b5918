"""Plain float32 layers of the reference models, and the reference's AdamW.

Each layer follows the published equations and not the program: OLMo's
norm with no parameters or RMSNorm with a scale (epsilon 1e-6), rotary
positions on interleaved pairs, causal softmax attention scaled by
1/sqrt(head width), a SwiGLU MLP or a routed mixture (softmax router, the
top k renormalised, every routed assignment computed: no capacity, so no
token is dropped) with shared experts beside it.  A family's module
(``families/<name>.py``) walks them in its model's order; the layers read
the benchmark's weights and nothing of the program.

Everything is float32 with TF32 off.  ``control=True`` rounds both inputs
of every linear layer but the router to float8 e4m3 (the activations per token, the
weights per output column): the precision below the configuration's
bfloat16, which the comparison has to tell apart from the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EPS = 1e-6
FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def bf16(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


ROUND = {"fp8": fp8, "bf16": bf16}


class Linear:
    """The linear layers of one pass: float32, or with both inputs rounded
    (``"fp8"``: the control; ``"bf16"``: a witness at the configuration's
    own precision), straight through, so a backward pass sees the rounded
    values."""

    def __init__(self, control=False):
        self.round = ROUND["fp8" if control is True else control] if control else None

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        if self.round:
            w = w + (self.round(w.detach(), -2) - w).detach()
        return w

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.round:
            x = x + (self.round(x.detach(), -1) - x).detach()
        return x @ w


def norm(model: dict, x: torch.Tensor, scale=None) -> torch.Tensor:
    if model["norm_type"] == "rmsnorm":
        out = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + EPS)
        return out * scale.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).pow(2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + EPS)


def rotary(model: dict, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """x (L, heads, Dh): pair (2i, 2i+1) turned by pos x theta^(-2i/Dh)."""
    Dh = x.shape[-1]
    inv = model["rope_theta"] ** (-torch.arange(0, Dh, 2, device=x.device).float() / Dh)
    ang = pos.float()[:, None] * inv  # (L, Dh/2)
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * c - b * s, b * c + a * s], dim=-1).flatten(-2)


def attention(model: dict, lin: Linear, p: dict, x: torch.Tensor, rows: int = 1024):
    """x (L, D) -> x + causal self-attention of norm(x)."""
    L, D = x.shape
    H, Hkv = model["num_heads"], model["num_kv_heads"]
    Dh = D // H
    h = norm(model, x, p.get("norm_scale"))
    pos = torch.arange(L, device=x.device)
    q = rotary(model, lin(h, p["wq"]).view(L, H, Dh), pos)
    k = rotary(model, lin(h, p["wk"]).view(L, Hkv, Dh), pos)
    v = lin(h, p["wv"]).view(L, Hkv, Dh)
    k, v = k.repeat_interleave(H // Hkv, 1), v.repeat_interleave(H // Hkv, 1)
    outs = []
    for r0 in range(0, L, rows):  # query rows in blocks, so the scores fit
        qi = q[r0:r0 + rows].transpose(0, 1)  # (H, r, Dh)
        s = qi @ k.permute(1, 2, 0) / math.sqrt(Dh)  # (H, r, L)
        later = pos[None, :] > pos[r0:r0 + rows, None]
        s = s.masked_fill(later, float("-inf"))
        outs.append((torch.softmax(s, -1) @ v.transpose(0, 1)).transpose(0, 1))
    o = torch.cat(outs).reshape(L, H * Dh)
    return x + lin(o, p["wo"])


def swiglu(lin: Linear, h, w_gate, w_up, w_down):
    return lin(F.silu(lin(h, w_gate)) * lin(h, w_up), w_down)


def ffn(model: dict, lin: Linear, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = norm(model, x, p.get("ffn_norm_scale"))
    if "w_router" not in p:
        return x + swiglu(lin, h, p["w_gate"], p["w_up"], p["w_down"])
    k = model["top_k"]
    gates = torch.softmax(h @ p["w_router"].float(), -1)  # the router in float32 always
    top_v, top_i = torch.topk(gates, k, -1)
    top_v = top_v / top_v.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(p["we_up"].shape[0]):
        tok, slot = (top_i == e).nonzero(as_tuple=True)
        if tok.numel():
            out = swiglu(lin, h[tok], p["we_gate"][e], p["we_up"][e], p["we_down"][e])
            y = y.index_add(0, tok, out * top_v[tok, slot, None])
    if "ws_up" in p:
        y = y + swiglu(lin, h, p["ws_gate"], p["ws_up"], p["ws_down"])
    return x + y


def gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below the best logit of its row."""
    return logits.max(-1).values - logits.gather(-1, tokens.long()[:, None])[:, 0]


# ------------------------------------------------------------------ training
def lr_at(opt: dict, step: int) -> float:
    if step < opt["warmup_steps"]:
        return opt["peak_lr"] * step / max(opt["warmup_steps"], 1)
    prog = min(max((step - opt["warmup_steps"]) / max(opt["decay_steps"] - opt["warmup_steps"], 1),
                   0.0), 1.0)
    frac = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (1 + math.cos(math.pi * prog))
    return opt["peak_lr"] * frac


def adamw_steps(loss_fn, opt: dict, flat: dict, batches: list, *, control: bool = False,
                rows: int = 2, keep_rows: int = 0) -> dict:
    """AdamW (global-norm clipping, decoupled weight decay on every leaf)
    over ``batches`` from the bfloat16 leaves ``flat``, on the summed loss
    ``loss_fn(w, lin, tokens, labels)`` of float32 leaves ``w`` (dotted
    names) that autograd follows.  Returns each step's
    mean loss, each leaf's clipped first gradient norm and each leaf's
    change after the last step.  The rows of a batch go through in blocks of
    ``rows``.  ``keep_rows`` > 0 takes the mean over the first rows alone (a
    planted fault: half of a batch left out)."""
    no_tf32()
    lin = Linear(control)
    w = {k: v.float().requires_grad_() for k, v in flat.items()}
    w0 = {k: v.detach().clone() for k, v in w.items()}
    m = {k: torch.zeros_like(v) for k, v in w.items()}
    s = {k: torch.zeros_like(v) for k, v in w.items()}
    losses, grad_norm = [], None
    for step, batch in enumerate(batches, start=1):
        tokens, labels = batch["tokens"], batch["labels"]
        if keep_rows:
            tokens, labels = tokens[:keep_rows], labels[:keep_rows]
        n = tokens.numel()
        total = 0.0
        for r0 in range(0, tokens.shape[0], rows):
            part = loss_fn(w, lin, tokens[r0:r0 + rows], labels[r0:r0 + rows]) / n
            part.backward()
            total += float(part.detach())
        losses.append(total)
        with torch.no_grad():
            g = {k: v.grad for k, v in w.items()}
            gn = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
            scale = min(1.0, opt["grad_clip"] / (float(gn) + 1e-9))
            if step == 1:
                grad_norm = {k: float(torch.linalg.vector_norm(x)) * scale for k, x in g.items()}
            lr = lr_at(opt, step)
            b1, b2 = opt["b1"], opt["b2"]
            for k, p in w.items():
                gk = g[k] * scale
                m[k].mul_(b1).add_(gk, alpha=1 - b1)
                s[k].mul_(b2).addcmul_(gk, gk, value=1 - b2)
                upd = (m[k] / (1 - b1 ** step)) / (torch.sqrt(s[k] / (1 - b2 ** step)) + opt["eps"])
                p.sub_(lr * (upd + opt["weight_decay"] * p))
                p.grad = None
    change = {k: float(torch.linalg.vector_norm(w[k].detach() - w0[k])) for k in w}
    return {"loss": losses, "grad_norm": grad_norm, "change": change}
