"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.
48L d_model=2048 d_ff=0 vocab=50280 ssm_state=128. [arXiv:2405.21060]

SWAT applicability: none (no QK^T) — see DESIGN.md §4. long_500k runs via
the O(1) recurrent state (the SSM counterpart of the ring cache).
"""
from repro_torch.core.types import AttentionSpec, ModelConfig, SSMSpec

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    num_layers=48,
    d_model=2048,
    num_heads=1, num_kv_heads=1,        # unused: attention-free
    d_ff=0,                             # mamba2 blocks have no separate FFN
    vocab_size=50280,
    layer_pattern=("mamba",),
    attention=AttentionSpec(kind="dense", causal=True),   # unused
    ssm=SSMSpec(state_dim=128, head_dim=64, expand=2, conv_width=4,
                chunk_size=256, num_groups=1),
    tie_embeddings=True,
    norm_eps=1e-5,
)
