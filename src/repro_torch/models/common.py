"""Model configuration and single-source parameter definitions (port of
``repro.models.common``).

Every architecture is described by a :class:`ModelConfig`; the parameter tree
(shapes, dtypes, initializers) is generated once by ``param_defs`` so real
init and shape checks can never diverge.  The JAX package's ``PartitionSpec``s
are left out: sharding is a later slice of the port.

Layers are organized in *periods*, the smallest repeating pattern of
(mixer, ffn) sublayer kinds; per-layer parameters carry a leading
``num_periods`` stack dim, as in the JAX package, and the model loops over it.

Every family and feature of the JAX package is here: dense attention + MLP,
Mixture-of-Experts (``moe``), Mamba2 (``mamba``), the hybrid of both
(jamba), cross-attention (``xattn``, llama-3.2-vision), the int8 KV cache
(``kv_quant``) and ``seq_parallel`` (a no-op without a mesh).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .. import default_device
from ..tree import unflatten


@dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    # layer pattern: tuple of (mixer, ffn) kinds, cycled over num_layers.
    # mixer: "attn" | "xattn" | "mamba"; ffn: "mlp" | "moe" | "none"
    pattern: tuple = (("attn", "mlp"),)
    # norms: "rmsnorm" | "layernorm" | "nonparametric_ln" (olmo)
    norm_type: str = "rmsnorm"
    # rope
    rope_theta: float = 1e4
    rope_fraction: float = 1.0  # chatglm3 2d-RoPE: rotate only half of head_dim
    # ffn
    ffn_act: str = "swiglu"  # "swiglu" | "gelu"
    # moe
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    # ssm (mamba2 / SSD)
    ssm_state: int = 128
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_kernel: int = 4
    ssm_chunk: int = 256
    # vlm/audio frontend stub
    num_encoder_tokens: int = 0
    # dtypes / numerics
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.bfloat16
    # training memory knobs
    remat: str = "full"  # "full" | "dots" | "none"
    optim_moment_dtype: Any = torch.float32
    optim_master_fp32: bool = True
    # sharding strategy knobs (kept for parity with the JAX config)
    fsdp_params: bool = True
    moe_ep: bool = False
    kv_quant: bool = False
    attn_bf16_scores: bool = False
    seq_parallel: bool = False
    # serving
    max_decode_batch: int = 128
    # metadata
    family: str = "dense"
    active_params_note: str = ""

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256; pad logits are masked to
        -1e30 in the unembed."""
        return (self.vocab_size + 255) // 256 * 256

    @property
    def num_periods(self) -> int:
        if self.num_layers % len(self.pattern):
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not a multiple of "
                f"pattern period {len(self.pattern)}"
            )
        return self.num_layers // len(self.pattern)

    @property
    def d_inner(self) -> int:  # mamba2
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def has(self, mixer_or_ffn: str) -> bool:
        return any(mixer_or_ffn in slot for slot in self.pattern)


_DTYPE_FIELDS = ("dtype", "param_dtype", "optim_moment_dtype")
_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _torch_dtype(value) -> torch.dtype:
    if isinstance(value, torch.dtype):
        return value
    name = value if isinstance(value, str) else np.dtype(value).name
    return _TORCH_DTYPES[name]


def from_reference_config(fields: dict) -> ModelConfig:
    """Build a :class:`ModelConfig` from the JAX config's field values.

    ``fields`` maps field names to plain values (for example
    ``dataclasses.asdict`` of a ``repro`` config); dtypes may be given as
    names (``"bfloat16"``), numpy dtypes or torch dtypes."""
    kw = dict(fields)
    for f in _DTYPE_FIELDS:
        if f in kw:
            kw[f] = _torch_dtype(kw[f])
    kw["pattern"] = tuple(tuple(slot) for slot in kw.get("pattern", (("attn", "mlp"),)))
    return ModelConfig(**kw)


# --------------------------------------------------------------------------
# Parameter definitions
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class ParamDef:
    shape: tuple
    init: str = "normal"  # normal | zeros | ones | scaled(fan_in)
    dtype: Any = None  # None -> cfg.param_dtype

    def with_stack(self, n: int) -> "ParamDef":
        return ParamDef((n,) + self.shape, self.init, self.dtype)


def _norm_defs(cfg: ModelConfig, prefix: str) -> dict:
    if cfg.norm_type == "nonparametric_ln":
        return {}
    d = {f"{prefix}_scale": ParamDef((cfg.d_model,), "ones")}
    if cfg.norm_type == "layernorm":
        d[f"{prefix}_bias"] = ParamDef((cfg.d_model,), "zeros")
    return d


def _inner_norm_defs(cfg: ModelConfig, prefix: str, dim: int) -> dict:
    if cfg.norm_type == "nonparametric_ln":
        return {}
    return {f"{prefix}_scale": ParamDef((dim,), "ones")}


def _attn_defs(cfg: ModelConfig, cross: bool = False) -> dict:
    D, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    defs = {
        "wq": ParamDef((D, H * Dh)),
        "wk": ParamDef((D, Hkv * Dh)),
        "wv": ParamDef((D, Hkv * Dh)),
        "wo": ParamDef((H * Dh, D), "scaled"),
    }
    defs.update(_norm_defs(cfg, "norm"))
    if cross:
        # the JAX package defines a norm of the encoder states and never
        # applies it (its cross_attn projects them as they are); kept so the
        # parameter trees match, and unused here too
        defs.update(_inner_norm_defs(cfg, "kv_norm", cfg.d_model))
    return defs


def _mlp_defs(cfg: ModelConfig) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    defs = {
        "w_up": ParamDef((D, F)),
        "w_down": ParamDef((F, D), "scaled"),
    }
    if cfg.ffn_act == "swiglu":
        defs["w_gate"] = ParamDef((D, F))
    defs.update(_norm_defs(cfg, "ffn_norm"))
    return defs


def _moe_defs(cfg: ModelConfig) -> dict:
    D, E, F = cfg.d_model, cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
    defs = {
        "w_router": ParamDef((D, E), dtype=torch.float32),
        "we_up": ParamDef((E, D, F)),
        "we_gate": ParamDef((E, D, F)),
        "we_down": ParamDef((E, F, D), "scaled"),
    }
    if cfg.num_shared_experts:
        Fs = cfg.num_shared_experts * F
        defs["ws_up"] = ParamDef((D, Fs))
        defs["ws_gate"] = ParamDef((D, Fs))
        defs["ws_down"] = ParamDef((Fs, D), "scaled")
    defs.update(_norm_defs(cfg, "ffn_norm"))
    return defs


def _mamba_defs(cfg: ModelConfig) -> dict:
    D, Din, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = Din + 2 * N  # x, B, C go through the causal conv
    defs = {
        # in_proj -> [z (gate), x, B, C, dt]
        "in_proj": ParamDef((D, 2 * Din + 2 * N + H)),
        "conv_w": ParamDef((cfg.ssm_conv_kernel, conv_dim)),
        "conv_b": ParamDef((conv_dim,), "zeros"),
        "A_log": ParamDef((H,), "ones", dtype=torch.float32),
        "ssm_D": ParamDef((H,), "ones", dtype=torch.float32),
        "dt_bias": ParamDef((H,), "zeros", dtype=torch.float32),
        "out_proj": ParamDef((Din, D), "scaled"),
    }
    defs.update(_norm_defs(cfg, "norm"))
    defs.update(_inner_norm_defs(cfg, "gate_norm", Din))
    return defs


MIXER_DEFS = {
    "attn": _attn_defs,
    "xattn": lambda c: _attn_defs(c, cross=True),
    "mamba": _mamba_defs,
}
FFN_DEFS = {"mlp": _mlp_defs, "moe": _moe_defs, "none": lambda c: {}}


def slot_defs(cfg: ModelConfig, mixer: str, ffn: str) -> dict:
    defs = {f"{mixer}.{k}": v for k, v in MIXER_DEFS[mixer](cfg).items()}
    defs.update({f"{ffn}.{k}": v for k, v in FFN_DEFS[ffn](cfg).items()})
    return defs


def param_defs(cfg: ModelConfig) -> dict:
    """Full parameter tree: {dotted name: ParamDef}. Per-layer params carry a
    leading ``num_periods`` stack dim."""
    n = cfg.num_periods
    defs: dict[str, ParamDef] = {
        "embed": ParamDef((cfg.padded_vocab, cfg.d_model)),
        "lm_head": ParamDef((cfg.d_model, cfg.padded_vocab)),
    }
    defs.update(_norm_defs(cfg, "final_norm"))
    for si, (mixer, ffn) in enumerate(cfg.pattern):
        for k, d in slot_defs(cfg, mixer, ffn).items():
            defs[f"layers.{si}.{k}"] = d.with_stack(n)
    return defs


def param_shapes(cfg: ModelConfig) -> dict:
    """Nested {name: (shape, dtype)} tree, the counterpart of the JAX
    package's ``abstract_params`` (nothing is allocated)."""
    return unflatten(
        {k: (d.shape, d.dtype or cfg.param_dtype) for k, d in param_defs(cfg).items()}
    )


def init_params(cfg: ModelConfig, generator, device=None) -> dict:
    """Random parameters with the JAX package's shapes and init rules.

    ``generator`` is a ``torch.Generator`` on ``device`` or an int seed.  The
    numbers differ from ``jax.random``'s for the same seed; tests that compare
    the two frameworks share parameters through numpy instead."""
    dev = default_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    flat = {}
    for name, d in sorted(param_defs(cfg).items()):
        dtype = d.dtype or cfg.param_dtype
        if d.init == "zeros":
            flat[name] = torch.zeros(d.shape, dtype=dtype, device=dev)
        elif d.init == "ones":
            flat[name] = torch.ones(d.shape, dtype=dtype, device=dev)
        else:
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            scale = 1.0 / math.sqrt(fan_in)
            if d.init == "scaled":  # extra depth scaling for output projections
                scale /= math.sqrt(2.0 * cfg.num_layers)
            w = torch.randn(
                d.shape, generator=generator, dtype=torch.float32, device=dev
            )
            flat[name] = w.mul_(scale).to(dtype)
    return unflatten(flat)


def count_params(cfg: ModelConfig) -> int:
    return sum(math.prod(d.shape) for d in param_defs(cfg).values())


def count_active_params(cfg: ModelConfig) -> int:
    """Active params per token (MoE: only top_k + shared experts count)."""
    total = 0
    for name, d in param_defs(cfg).items():
        n = math.prod(d.shape)
        if ".we_" in name:  # routed experts: top_k of E active
            n = n * cfg.top_k // max(cfg.num_experts, 1)
        total += n
    return total


# --------------------------------------------------------------------------
# Norm application
# --------------------------------------------------------------------------
def apply_norm(cfg: ModelConfig, x: torch.Tensor, params: dict, prefix: str) -> torch.Tensor:
    """Normalization with fp32 *statistics* but the full-size multiply kept in
    the activation dtype (as the JAX package does)."""
    xf = x.float()
    if cfg.norm_type == "rmsnorm":
        r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
        out = x * r.to(x.dtype)
        return out * params[f"{prefix}_scale"].to(x.dtype)
    # layernorm / olmo's non-parametric LN
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    r = torch.rsqrt(var + 1e-6)
    out = (x - mu.to(x.dtype)) * r.to(x.dtype)
    if cfg.norm_type == "nonparametric_ln":
        return out
    out = out * params[f"{prefix}_scale"].to(x.dtype)
    if f"{prefix}_bias" in params:
        out = out + params[f"{prefix}_bias"].to(x.dtype)
    return out


def inner_norm(x: torch.Tensor, params: dict, prefix: str, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last dim with an optional ``<prefix>_scale`` (the
    mamba2 gate norm); fp32 statistics, multiply in the activation dtype."""
    xf = x.float()
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    out = x * r.to(x.dtype)
    scale = params.get(f"{prefix}_scale")
    if scale is not None:
        out = out * scale.to(x.dtype)
    return out
