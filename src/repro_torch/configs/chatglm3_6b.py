"""chatglm3-6b [dense] — 2d-RoPE (rotate half of head_dim), GQA kv=2
[arXiv:2406.12793]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    pattern=(("attn", "mlp"),),
    norm_type="rmsnorm",
    ffn_act="swiglu",
    rope_theta=1e4,
    rope_fraction=0.5,  # GLM's 2d rope: only half the head dims rotate
)
