"""mamba2-780m [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060]. d_inner = 2*d_model = 3072, head_dim 64 -> 48 SSD heads,
state N=128."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    pattern=(("mamba", "none"),),
    norm_type="rmsnorm",
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
)
