"""The family of a stack of identical decoder layers: attention, then a
SwiGLU MLP or a routed mixture of experts (olmo-1b, qwen2-moe-a2.7b).

Its weights' layout, the walk of the reference's float32 layers over it,
its model FLOPs and its kernels' bounds.  Model FLOPs count the products a
token needs (2 per weight of every linear layer it passes through, the
output head included, the embedding lookup not) and attention over the
positions it really attends.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from portbench import counts
from portbench.reference import Linear, adamw_steps, attention, ffn, no_tf32, norm

KERNELS = (("flash_fwd", "k4_bound_s"), ("dispatch_one_kernel", "k3_bound_s"))


# ------------------------------------------------------------------ weights
def padded_vocab(model: dict) -> int:
    return (model["vocab_size"] + 255) // 256 * 256


def head_dim(model: dict) -> int:
    return model["d_model"] // model["num_heads"]


def _norm(model: dict, name: str, lead: tuple) -> dict:
    if model["norm_type"] == "nonparametric_ln":
        return {}
    if model["norm_type"] != "rmsnorm":
        raise ValueError(f"norm {model['norm_type']!r} is not in the reference")
    return {f"{name}_scale": (lead + (model["d_model"],), "ones", "bfloat16")}


def layout(model: dict) -> dict:
    """{dotted name: (shape, init, dtype name)} of every leaf, sorted by name."""
    D, H, Dh, n = model["d_model"], model["num_heads"], head_dim(model), model["num_layers"]
    Hkv, V = model["num_kv_heads"], padded_vocab(model)
    bf = "bfloat16"
    leaves = {"embed": ((V, D), "normal", bf), "lm_head": ((D, V), "normal", bf)}
    leaves.update(_norm(model, "final_norm", ()))
    attn = {"wq": ((n, D, H * Dh), "normal", bf), "wk": ((n, D, Hkv * Dh), "normal", bf),
            "wv": ((n, D, Hkv * Dh), "normal", bf), "wo": ((n, H * Dh, D), "scaled", bf)}
    attn.update(_norm(model, "norm", (n,)))
    leaves.update({f"layers.0.attn.{k}": v for k, v in attn.items()})
    if model.get("num_experts"):
        E, Fe = model["num_experts"], model["moe_d_ff"]
        Fs = model["num_shared_experts"] * Fe
        mix = {"w_router": ((n, D, E), "normal", "float32"),
               "we_up": ((n, E, D, Fe), "normal", bf), "we_gate": ((n, E, D, Fe), "normal", bf),
               "we_down": ((n, E, Fe, D), "scaled", bf)}
        if Fs:
            mix.update({"ws_up": ((n, D, Fs), "normal", bf), "ws_gate": ((n, D, Fs), "normal", bf),
                        "ws_down": ((n, Fs, D), "scaled", bf)})
        kind = "moe"
    else:
        Ff = model["d_ff"]
        mix = {"w_up": ((n, D, Ff), "normal", bf), "w_gate": ((n, D, Ff), "normal", bf),
               "w_down": ((n, Ff, D), "scaled", bf)}
        kind = "mlp"
    mix.update(_norm(model, "ffn_norm", (n,)))
    leaves.update({f"layers.0.{kind}.{k}": v for k, v in mix.items()})
    return dict(sorted(leaves.items()))


def tiny(model: dict) -> dict:
    """Two layers of width 64 and a vocabulary of 256; 8 experts, top 2."""
    out = dict(model, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
               vocab_size=256)
    if out.get("num_experts"):
        out.update(num_experts=8, top_k=2, moe_d_ff=32, num_shared_experts=2, capacity_factor=4.0)
    return out


# ---------------------------------------------------------------- reference
def layer_weights(params: dict, i: int, lin: Linear) -> dict:
    """Layer ``i`` of the stacked tree, in float32 (the control's rounded)."""
    out = {}
    for block in params["layers"]["0"].values():
        for name, t in block.items():
            w = t[i]
            keep = name.endswith("_scale") or name == "w_router"
            out[name] = w.float() if keep else lin.weight(w)
    return out


def split(p: dict) -> tuple[dict, dict]:
    at = {k: p[k] for k in ("wq", "wk", "wv", "wo", "norm_scale") if k in p}
    return at, {k: v for k, v in p.items() if k not in at}


def logits_at(model: dict, params: dict, lin: Linear, h: torch.Tensor) -> torch.Tensor:
    h = norm(model, h, params.get("final_norm_scale"))
    return lin(h, lin.weight(params["lm_head"]))[:, : model["vocab_size"]]


@torch.no_grad()
def served_logits(model: dict, params: dict, seqs: list, wanted: list,
                  control: bool = False) -> list:
    """For each token sequence (L,) the logits (len(wanted), vocab) at the
    positions ``wanted`` of a full causal pass, computed layer by layer over
    all sequences (each layer's weights made float32 once)."""
    no_tf32()
    lin = Linear(control)
    hs = [params["embed"][s.long()].float() for s in seqs]
    for i in range(model["num_layers"]):
        at, ff = split(layer_weights(params, i, lin))
        hs = [ffn(model, lin, ff, attention(model, lin, at, h)) for h in hs]
        del at, ff
    return [logits_at(model, params, lin, h[w]) for h, w in zip(hs, wanted)]


def train_loss(model: dict, w: dict, lin: Linear, tokens, labels) -> torch.Tensor:
    """Sum over the rows' positions of the next-token NLL, for float32
    leaves ``w`` (dotted names) that autograd follows."""
    layers = {k[len("layers.0."):]: v for k, v in w.items() if k.startswith("layers.0.")}
    loss = torch.zeros((), device=tokens.device)
    for b in range(tokens.shape[0]):
        x = w["embed"][tokens[b].long()]
        for i in range(model["num_layers"]):
            p = {name.split(".", 1)[1]: t[i] for name, t in layers.items()}
            at, ff = split({k: (v if k.endswith("_scale") else lin.weight(v)) for k, v in p.items()})
            x = ffn(model, lin, ff, attention(model, lin, at, x))
        logits = logits_at(model, {"lm_head": w["lm_head"], **(
            {"final_norm_scale": w["final_norm_scale"]} if "final_norm_scale" in w else {})},
            lin, x)
        loss = loss + F.cross_entropy(logits, labels[b].long(), reduction="sum")
    return loss


def train_steps(model: dict, opt: dict, flat: dict, batches: list, **kw) -> dict:
    return adamw_steps(functools.partial(train_loss, model), opt, flat, batches, **kw)


# ------------------------------------------------------------------- counts
def linear_weights(model: dict) -> int:
    """Weights of the linear layers one token passes through (routed
    experts: top_k of them; the router and the output head included)."""
    D, H, n = model["d_model"], model["num_heads"], model["num_layers"]
    Dh = D // H
    attn = D * Dh * (2 * H + 2 * model["num_kv_heads"])
    if model.get("num_experts"):
        Fe = model["moe_d_ff"]
        mix = 3 * D * Fe * (model["top_k"] + model["num_shared_experts"]) + D * model["num_experts"]
    else:
        mix = 3 * D * model["d_ff"]
    return n * (attn + mix) + D * model["vocab_size"]


def attention_flops(model: dict, positions: float) -> float:
    """Forward FLOPs of attention for query-key pairs summed over a token's
    positions: 4 x head width x heads a pair, in every layer."""
    return 4.0 * positions * model["d_model"] * model["num_layers"]


def prefill_flops(model: dict, seq: int) -> float:
    """A prompt of ``seq`` tokens through the model; the head at the last position."""
    body = linear_weights(model) - model["d_model"] * model["vocab_size"]
    return 2.0 * seq * body + 2.0 * model["d_model"] * model["vocab_size"] \
        + attention_flops(model, seq * (seq + 1) / 2)


def decode_flops(model: dict, positions) -> float:
    """One decode step of the active slots; ``positions`` their write indices."""
    return sum(2.0 * linear_weights(model) + attention_flops(model, p + 1) for p in positions)


def train_flops(model: dict, batch: int, seq: int) -> float:
    """One training step: 3 x the forward (no recomputation counted)."""
    return 3.0 * batch * (2.0 * seq * linear_weights(model)
                          + attention_flops(model, seq * (seq + 1) / 2))


# ------------------------------------------------------------------- bounds
def _k3(model: dict, tokens: int) -> float:
    """Every assignment is kept: the configuration's capacity drops none."""
    if not model.get("num_experts"):
        return 0.0
    return model["num_layers"] * counts.bound_s(
        *counts.k3(tokens, model["top_k"], model["num_experts"], model["d_model"]))


def _k4(model: dict, batch: int, seq: int) -> float:
    """One causal K4 forward of every head at ``batch`` x ``seq``."""
    H = model["num_heads"]
    return counts.bound_s(*counts.k4(batch, seq, H, model["num_kv_heads"], model["d_model"] // H))


def prefill_bounds(model: dict, seq: int) -> dict:
    """K4 in every layer and K3 in every MoE layer, over one prompt."""
    return {"k4_bound_s": model["num_layers"] * _k4(model, 1, seq), "k3_bound_s": _k3(model, seq)}


def decode_bounds(model: dict, slots: int) -> dict:
    """A decode step dispatches every slot's row; its attention is not K4."""
    return {"k4_bound_s": 0.0, "k3_bound_s": _k3(model, slots)}


def launches() -> dict:
    from repro_torch.kernels.attention.ops import flash_attention

    return {"k4": flash_attention.LAUNCHES}


def train_bounds(model: dict, batch: int, seq: int, calls: dict) -> dict:
    """K4 as often as the program's counter advanced in a step (the forward
    and the recompute)."""
    return {"k4_bound_s": calls["k4"] * _k4(model, batch, seq)}
