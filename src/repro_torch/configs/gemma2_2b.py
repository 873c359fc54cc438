"""gemma2-2b [dense] — local+global alternating attention, logit softcaps.
26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000. [arXiv:2408.00118]

The native fit for the paper: the 13 local layers ARE sliding-window
attention (w=4096) and use the SWAT kernel in the faithful config.
"""
from repro_torch.core.types import AttentionSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    num_layers=26,
    d_model=2304,
    num_heads=8, num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    layer_pattern=("local_attn", "attn"),
    local_attention=AttentionSpec(kind="swat", window=4096, causal=True,
                                  softcap=50.0),
    attention=AttentionSpec(kind="dense", causal=True, softcap=50.0),
    final_softcap=30.0,
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
    norm_eps=1e-6,
)
