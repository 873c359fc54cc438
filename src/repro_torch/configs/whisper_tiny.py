"""whisper-tiny [audio] — encoder-decoder with conv frontend STUB.
4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865. [arXiv:2212.04356]

input_specs feeds precomputed frame embeddings (the conv1+conv2 frontend is
the assignment-mandated stub); encoder is bidirectional self-attention,
decoder is causal self + cross attention. Structural decoder limit 448 —
decode_32k is lowered mechanically on the backbone; long_500k skipped
(DESIGN.md §4).
"""
from repro_torch.core.types import AttentionSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    num_layers=4,                       # decoder layers
    encoder_layers=4,
    encoder_decoder=True,
    d_model=384,
    num_heads=6, num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    layer_pattern=("xattn",),
    attention=AttentionSpec(kind="dense", causal=True),
    use_rope=False,                     # sinusoidal absolute positions
    frontend="audio",
    max_decode_len=448,
    norm_eps=1e-5,
)

ENCODER_FRAMES = 1500                   # 30 s of audio after conv frontend
