"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e
top-2 every other layer [arXiv:2403.19887]. Period of 8 layers: attention at
slot 4, MoE on odd slots; 72 layers = 9 periods. 398B total / ~94B active.
Optimizer states bf16 + no fp32 master (the JAX package's setting for 256
chips)."""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    pattern=(
        ("mamba", "mlp"),
        ("mamba", "moe"),
        ("mamba", "mlp"),
        ("mamba", "moe"),
        ("attn", "mlp"),
        ("mamba", "moe"),
        ("mamba", "mlp"),
        ("mamba", "moe"),
    ),
    norm_type="rmsnorm",
    ffn_act="swiglu",
    num_experts=16,
    top_k=2,
    moe_d_ff=24576,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    rope_theta=1e6,
    optim_moment_dtype=torch.bfloat16,
    optim_master_fp32=False,
)
