"""llama-3.2-vision-90b [vlm] — 100 layers: cross-attn image layer every 5th
(80 self + 20 cross), GQA kv=8 [hf:meta-llama/Llama-3.2-90B-Vision].
Vision frontend is a STUB: the caller passes precomputed patch embeddings
(B, 576, d_model) as ``encoder_states``, read by the cross-attention
layers."""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    pattern=(
        ("attn", "mlp"),
        ("attn", "mlp"),
        ("attn", "mlp"),
        ("attn", "mlp"),
        ("xattn", "mlp"),
    ),
    norm_type="rmsnorm",
    ffn_act="swiglu",
    rope_theta=5e5,
    num_encoder_tokens=576,
    optim_moment_dtype=torch.bfloat16,  # 90B: keep optimizer state lean
)
