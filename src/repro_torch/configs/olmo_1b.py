"""olmo-1b [dense] — non-parametric LN [arXiv:2402.00838; hf]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    pattern=(("attn", "mlp"),),
    norm_type="nonparametric_ln",
    ffn_act="swiglu",
    rope_theta=1e4,
)
