"""internvl2-1b [vlm] — InternViT + Qwen2-0.5B-style LM backbone.
24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655. [arXiv:2404.16821]

Backbone only per assignment: the ViT patch tower is a STUB — input_specs
feeds precomputed patch(+text) embeddings for train/prefill; decode embeds
text tokens normally.
"""
from repro_torch.core.types import AttentionSpec, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    num_layers=24,
    d_model=896,
    num_heads=14, num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    layer_pattern=("attn",),
    attention=AttentionSpec(kind="dense", causal=True),
    qkv_bias=True,                       # qwen2 family uses QKV bias
    frontend="vision",                   # patch-embedding stub at train/prefill
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    norm_eps=1e-6,
)
