"""granite-8b [dense] — llama-architecture code model.
36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152. [arXiv:2405.04324]
"""
from repro_torch.core.types import AttentionSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    num_layers=36,
    d_model=4096,
    num_heads=32, num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    layer_pattern=("attn",),
    attention=AttentionSpec(kind="dense", causal=True),
    rope_theta=10_000_000.0,
    tie_embeddings=True,
    norm_eps=1e-5,
)
