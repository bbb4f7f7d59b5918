"""musicgen-large [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284]. Backbone only: the EnCodec frontend is a stub; inputs are
code tokens (vocab 2048). LayerNorm + GELU per the original transformer LM;
positional encoding adapted to RoPE (framework-native; noted in DESIGN.md).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    pattern=(("attn", "mlp"),),
    norm_type="layernorm",
    ffn_act="gelu",
    rope_theta=1e4,
)
