"""The paper's BigBird configuration (Table 2): 192 sliding-window tokens,
192 random tokens, 128 global tokens = 512 attended tokens per row.

Random attention is block-granular in both BigBird and SWAT (whole K/V
buffers assigned to random cores); with block_kv=128 we use 2 random blocks
(~256 tokens, the closest block multiple to 192 — noted approximation).
"""
from repro_torch.core.types import AttentionSpec, ModelConfig

CONFIG = ModelConfig(
    name="bigbird-paper",
    num_layers=12,
    d_model=768,
    num_heads=12, num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=50358,
    layer_pattern=("attn",),
    attention=AttentionSpec(kind="swat", window=96, num_global=128,
                            num_random=2, random_seed=2024, causal=False),
    norm_eps=1e-5,
)
