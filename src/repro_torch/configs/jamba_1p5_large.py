"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE.
72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
[arXiv:2403.19887]

Period-8 super-block: 7 mamba + 1 attention (position 4, as in the Jamba
paper), MoE on every other layer => 4 MoE layers per super-block.
~398B total / ~98B active parameters.
"""
from repro_torch.core.types import AttentionSpec, ModelConfig, MoESpec, SSMSpec

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    num_layers=72,
    d_model=8192,
    num_heads=64, num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    layer_pattern=("mamba", "mamba_moe", "mamba", "mamba_moe",
                   "attn", "mamba_moe", "mamba", "mamba_moe"),
    attention=AttentionSpec(kind="dense", causal=True),
    moe=MoESpec(num_experts=16, top_k=2),
    ssm=SSMSpec(state_dim=128, head_dim=64, expand=2, conv_width=4,
                chunk_size=256, num_groups=1),
    norm_eps=1e-5,
)
