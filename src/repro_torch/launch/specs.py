"""Meta-device stand-ins for every model input: the dry-run's inputs (the
port of the JAX package's `launch/specs.py`, whose ShapeDtypeStructs these
are).

Empty tensors on the meta device: shapes and dtypes, zero allocation.
Covers the four assigned shape cells (train_4k / prefill_32k / decode_32k
/ long_500k) for every architecture family (LM, VLM-stub, audio-stub
enc-dec, SSM, hybrid, MoE).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch import tree
from repro_torch.core import model as Mod
from repro_torch.core.types import ModelConfig, ShapeConfig

ENCODER_FRAMES = 1500    # whisper 30 s after the conv frontend (stubbed)


def _act_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    """Batch specs for the step function this cell runs (train/prefill:
    full sequence; decode: one token)."""
    b, l = shape.global_batch, shape.seq_len
    dt = _act_dtype(cfg)
    if shape.mode == "decode":
        return {"tokens": _meta((b, 1), torch.int32)}
    batch: Dict[str, torch.Tensor] = {}
    if cfg.frontend == "vision":
        # stub: pre-fused patch+text embeddings
        batch["embeddings"] = _meta((b, l, cfg.d_model), dt)
    else:
        batch["tokens"] = _meta((b, l), torch.int32)
    if cfg.encoder_decoder:
        batch["enc_embeddings"] = _meta((b, ENCODER_FRAMES, cfg.d_model), dt)
    if shape.mode == "train":
        batch["labels"] = _meta((b, l), torch.int32)
    return batch


def param_specs(cfg: ModelConfig):
    return Mod.init_model(cfg, device="meta")


def cache_specs(cfg: ModelConfig, shape: ShapeConfig):
    assert shape.mode == "decode"
    enc_len = ENCODER_FRAMES if cfg.encoder_decoder else 0
    return Mod.init_caches(cfg, shape.global_batch, shape.seq_len,
                           enc_len=enc_len, device="meta")


def param_count(cfg: ModelConfig) -> int:
    return sum(math.prod(x.shape) for x in tree.leaves(param_specs(cfg)))


def active_param_count(cfg: ModelConfig) -> int:
    """MoE: experts beyond top_k are inactive per token (a `moe/` leaf
    ending in w1, w2 or w3 counts top_k / num_experts of its size)."""
    total = 0
    for path, x in tree.flatten_with_paths(param_specs(cfg)):
        n = math.prod(x.shape)
        if "moe/" in path and any(path.endswith(s)
                                  for s in ("w1", "w2", "w3")):
            n = n * cfg.moe.top_k // cfg.moe.num_experts
        total += n
    return total
