"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64 experts top-6.
48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64e top-6.
[hf:moonshotai/Moonlight-16B-A3B]
"""
from repro_torch.core.types import AttentionSpec, ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    num_layers=48,
    d_model=2048,
    num_heads=16, num_kv_heads=16,
    head_dim=128,
    d_ff=1408,                          # per-expert FFN width
    vocab_size=163840,
    layer_pattern=("attn_moe",),
    attention=AttentionSpec(kind="dense", causal=True),
    moe=MoESpec(num_experts=64, top_k=6),
    rope_theta=50_000.0,
    norm_eps=1e-5,
)
