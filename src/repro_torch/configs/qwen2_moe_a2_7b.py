"""qwen2-moe-a2.7b [moe] — 60 routed experts top-4 + 4 shared experts,
expert d_ff=1408 [hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    pattern=(("attn", "moe"),),
    norm_type="rmsnorm",
    ffn_act="swiglu",
    num_experts=60,
    top_k=4,
    moe_d_ff=1408,
    num_shared_experts=4,
    rope_theta=1e6,
)
