"""Architecture registry (port of ``repro.configs.registry``).

``get_config(arch_id)`` returns the exact assigned configuration;
``smoke_config(arch_id)`` returns a structurally identical reduced config
small enough for a CPU forward pass.  Architectures whose families are not
ported yet (the hybrid jamba and the cross-attention llama-3.2-vision)
raise ``KeyError``.
"""
from __future__ import annotations

import dataclasses
import importlib

_MODULES = {
    "olmo-1b": "olmo_1b",
    "glm4-9b": "glm4_9b",
    "chatglm3-6b": "chatglm3_6b",
    "starcoder2-15b": "starcoder2_15b",
    "musicgen-large": "musicgen_large",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "mamba2-780m": "mamba2_780m",
}

# The JAX package's other architectures; each gets its module with its slice.
_NOT_YET_PORTED = (
    "llama-3.2-vision-90b",
    "jamba-1.5-large-398b",
)

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str):
    if arch_id in _NOT_YET_PORTED:
        raise KeyError(f"arch {arch_id!r} not yet ported; ported: {sorted(_MODULES)}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def smoke_config(arch_id: str, num_periods: int = 2):
    """Reduced config of the same family: small dims, few experts, tiny vocab."""
    cfg = get_config(arch_id)
    period = len(cfg.pattern)
    heads = 4 if cfg.num_heads else 0
    kv = min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0
    changes = dict(
        name=cfg.name + "-smoke",
        num_layers=period * num_periods,
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv or heads if heads else 0,
        head_dim=16 if heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        num_encoder_tokens=16 if cfg.num_encoder_tokens else 0,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_chunk=8,
        remat="none",
    )
    if cfg.num_experts:
        changes.update(
            num_experts=min(cfg.num_experts, 8),
            top_k=min(cfg.top_k, 2),
            moe_d_ff=64,
            num_shared_experts=min(cfg.num_shared_experts, 2),
        )
    return dataclasses.replace(cfg, **changes)
