"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2, expert d_ff=6400
[hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    pattern=(("attn", "moe"),),
    norm_type="layernorm",
    ffn_act="swiglu",
    num_experts=16,
    top_k=2,
    moe_d_ff=6400,
    rope_theta=1e4,
)
