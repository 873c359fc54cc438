"""Architecture registry (host-side copy of the JAX package's
`configs/`): one module per assigned arch (+ the paper's own
Longformer/BigBird models). `get_config(name)` returns the full-size
ModelConfig; `get_smoke_config(name)` a structurally-identical reduced one
for CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

from repro_torch.core.types import AttentionSpec, ModelConfig, MoESpec, SSMSpec

ARCH_IDS = (
    "mamba2_1p3b",
    "internvl2_1b",
    "llama3p2_1b",
    "qwen2p5_32b",
    "granite_8b",
    "gemma2_2b",
    "whisper_tiny",
    "jamba_1p5_large",
    "granite_moe_1b",
    "moonshot_v1_16b",
)
PAPER_IDS = ("longformer_paper", "bigbird_paper")

_ALIASES = {
    "mamba2-1.3b": "mamba2_1p3b",
    "internvl2-1b": "internvl2_1b",
    "llama3.2-1b": "llama3p2_1b",
    "qwen2.5-32b": "qwen2p5_32b",
    "granite-8b": "granite_8b",
    "gemma2-2b": "gemma2_2b",
    "whisper-tiny": "whisper_tiny",
    "jamba-1.5-large-398b": "jamba_1p5_large",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b",
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "p"))


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return reduce_config(get_config(name))


def with_swat(cfg: ModelConfig, window: int = 2048,
              num_global: int = 128) -> ModelConfig:
    """Beyond-paper variant: swap every dense attention layer for SWAT
    window(+sink) attention — the paper's pitch applied to a modern LM.
    No-op for attention-free archs."""
    if cfg.is_attention_free:
        return cfg
    new_attn = dataclasses.replace(
        cfg.attention, kind="swat", window=window, num_global=num_global)
    return dataclasses.replace(cfg, name=cfg.name + "+swat",
                               attention=new_attn)


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Shrink every capacity knob while preserving structure (pattern, GQA
    ratio, MoE/SSM/bias/softcap flags)."""
    ratio = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
    heads = min(cfg.num_heads, 4)
    kv = max(1, heads // ratio)
    moe = (MoESpec(num_experts=min(cfg.moe.num_experts, 4),
                   top_k=min(cfg.moe.top_k, 2))
           if cfg.moe.enabled else MoESpec())
    ssm = dataclasses.replace(cfg.ssm, state_dim=min(cfg.ssm.state_dim, 16),
                              head_dim=min(cfg.ssm.head_dim, 16),
                              chunk_size=16)

    def shrink_spec(spec: Optional[AttentionSpec]):
        if spec is None:
            return None
        return dataclasses.replace(
            spec, window=min(spec.window, 16) if spec.window else 0,
            num_global=min(spec.num_global, 4),
            num_random=min(spec.num_random, 1))

    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=2 * len(cfg.layer_pattern),
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=min(cfg.d_ff, 128),
        vocab_size=min(cfg.vocab_size, 256),
        attention=shrink_spec(cfg.attention),
        local_attention=shrink_spec(cfg.local_attention),
        moe=moe,
        ssm=ssm,
        encoder_layers=min(cfg.encoder_layers, 2),
        dtype="float32",
    )
