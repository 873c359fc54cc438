"""granite-moe-1b-a400m [moe] — 32 experts top-8.
24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32e top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from repro_torch.core.types import AttentionSpec, ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    num_layers=24,
    d_model=1024,
    num_heads=16, num_kv_heads=8,
    head_dim=64,
    d_ff=512,                           # per-expert FFN width
    vocab_size=49155,
    layer_pattern=("attn_moe",),
    attention=AttentionSpec(kind="dense", causal=True),
    moe=MoESpec(num_experts=32, top_k=8),
    tie_embeddings=True,
    norm_eps=1e-6,
)
