"""The paper's own primary model: Longformer (window attention, 2w=512).

SWAT §4: "standard window width configuration (2w = 512), 512 attention
cores", head dim H=64. Longformer-base backbone: 12L d_model=768 12H
d_ff=3072. Bidirectional (LRA-style encoder) with 1 global CLS token.
"""
from repro_torch.core.types import AttentionSpec, ModelConfig

CONFIG = ModelConfig(
    name="longformer-paper",
    num_layers=12,
    d_model=768,
    num_heads=12, num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=50265,
    layer_pattern=("attn",),
    attention=AttentionSpec(kind="swat", window=256, num_global=1,
                            causal=False),
    norm_eps=1e-5,
)
