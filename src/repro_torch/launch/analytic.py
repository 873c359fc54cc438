"""Analytic per-step FLOP/byte model (the port of the JAX package's
`launch/analytic.py`): exact matmul counting from the config. Cross-checks
the dry-run's counted FLOPs (useful_flops_ratio) and covers any cell whose
trace is too expensive to run.

Conventions: 1 MAC = 2 FLOPs; training = fwd + 2x bwd (+1x fwd recompute
under full remat); attention FLOPs follow the spec's band/global columns
(SWAT's exact-band accounting, not sliding-chunks)."""
from __future__ import annotations

from repro_torch.core.types import AttentionSpec, ModelConfig, ShapeConfig


def _attn_cols(spec: AttentionSpec, seq: int) -> float:
    if not spec.is_sparse:
        return seq / 2 if spec.causal else seq
    cols = min(seq, (spec.window if spec.causal else 2 * spec.window) + 1)
    cols += min(spec.num_global, seq)
    cols += spec.num_random * 128          # random blocks (block_kv=128)
    return min(cols, seq)


def layer_flops_fwd(cfg: ModelConfig, kind: str, seq: int) -> float:
    """FLOPs for `seq` tokens through one layer (fwd)."""
    dm, dh = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    f = 0.0
    if kind.startswith("mamba"):
        s = cfg.ssm
        di = s.d_inner(dm)
        h = s.num_heads(dm)
        conv_dim = di + 2 * s.num_groups * s.state_dim
        f += 2 * seq * dm * (2 * di + 2 * s.num_groups * s.state_dim + h)
        f += 2 * seq * conv_dim * s.conv_width           # depthwise conv
        q = min(s.chunk_size, seq)
        f += 2 * seq * q * h * (s.head_dim + s.state_dim)    # intra-chunk
        f += 4 * seq * h * s.head_dim * s.state_dim          # states+inter
        f += 2 * seq * di * dm                               # out_proj
    else:
        spec = (cfg.local_attention if kind == "local_attn"
                else cfg.attention)
        cols = _attn_cols(spec, seq)
        f += 2 * seq * dm * dh * (hq + 2 * hkv)              # qkv proj
        f += 2 * seq * hq * cols * dh * 2                    # QK^T + PV
        f += 2 * seq * hq * dh * dm                          # out proj
    if kind == "xattn":
        enc = 1500
        f += 2 * seq * dm * dh * hq + 2 * enc * dm * dh * 2 * hkv
        f += 2 * seq * hq * enc * dh * 2
        f += 2 * seq * hq * dh * dm
    if kind.endswith("_moe") and cfg.moe.enabled:
        f += 2 * seq * dm * cfg.moe.num_experts              # router
        f += 6 * seq * cfg.moe.top_k * dm * cfg.d_ff         # active experts
    elif cfg.d_ff > 0 and not kind.startswith("mamba_moe"):
        f += 6 * seq * dm * cfg.d_ff                         # gated MLP
    return f


def step_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Whole-step FLOPs (all devices)."""
    b = shape.global_batch
    seq = 1 if shape.mode == "decode" else shape.seq_len
    per_layer = sum(layer_flops_fwd(cfg, k, seq)
                    for k in cfg.layer_pattern) * cfg.num_super_blocks
    head = 2 * seq * cfg.d_model * cfg.vocab_size
    if cfg.encoder_decoder and shape.mode != "decode":
        enc = 1500
        per_layer += cfg.encoder_layers * (
            2 * enc * cfg.d_model * cfg.resolved_head_dim
            * (cfg.num_heads + 2 * cfg.num_kv_heads)
            + 2 * enc * cfg.num_heads * enc * cfg.resolved_head_dim * 2
            + 2 * enc * cfg.num_heads * cfg.resolved_head_dim * cfg.d_model
            + 6 * enc * cfg.d_model * cfg.d_ff)
    if shape.mode == "decode":
        # decode attention reads the whole cache: cols = cache length
        cache_flops = 0.0
        for k in cfg.layer_pattern:
            if k.startswith("mamba"):
                continue
            spec = (cfg.local_attention if k == "local_attn"
                    else cfg.attention)
            cap = (min(spec.window + 1 + spec.num_global, shape.seq_len)
                   if spec.is_sparse else shape.seq_len)
            cache_flops += 2 * cfg.num_heads * cap \
                * cfg.resolved_head_dim * 2
        per_layer += cache_flops * cfg.num_super_blocks
    total_fwd = (per_layer + head) * b
    if shape.mode == "train":
        return total_fwd * 4.0      # fwd + bwd(2x) + remat recompute(1x)
    return total_fwd


def step_param_bytes(cfg: ModelConfig, n_params: int,
                     shape: ShapeConfig) -> float:
    """Minimum parameter traffic per step (each param read once, bf16;
    training adds grad write + fp32 optimizer read/write)."""
    if shape.mode == "train":
        return n_params * (2 + 2 + 2 + 16 + 8)   # p, g(w+r), m/v rw fp32
    return n_params * 2.0
