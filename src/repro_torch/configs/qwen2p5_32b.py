"""qwen2.5-32b [dense] — GQA with QKV bias.
64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064. [hf:Qwen/Qwen2.5]
"""
from repro_torch.core.types import AttentionSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    num_layers=64,
    d_model=5120,
    num_heads=40, num_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    layer_pattern=("attn",),
    attention=AttentionSpec(kind="dense", causal=True),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    norm_eps=1e-6,
)
