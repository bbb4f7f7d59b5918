"""starcoder2-15b [dense] — GQA kv=4, RoPE, LayerNorm+GELU [arXiv:2402.19173]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    pattern=(("attn", "mlp"),),
    norm_type="layernorm",
    ffn_act="gelu",
    rope_theta=1e5,
)
