"""Attention-only decoder LM (the port of the JAX package's `core/model.py`
for the layer kinds "attn" and "local_attn").

Params are a plain dict with the JAX package's leaf layouts, except that
the stacked super-blocks (`blocks/l{i}/...` with a leading num_super_blocks
axis) are a Python list of per-super-block dicts (`interop.params_from_jax`
unstacks them). Caches follow the same rule: a list over super-blocks of
{"l{i}": ring cache}. Decode updates caches IN PLACE.

`impl` selects the attention implementation (see `kernels/ops.py`); the
default is the CUDA kernels for CUDA tensors and the plain versions for CPU
tensors. Other layer kinds (mamba, MoE, cross-attention) raise
NotImplementedError: they belong to later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import layers as L
from repro_torch.core.types import AttentionSpec, ModelConfig

Params = Dict[str, Any]
Caches = List[Dict[str, Dict[str, torch.Tensor]]]
_KINDS = ("attn", "local_attn")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_supported(cfg: ModelConfig) -> None:
    bad = [k for k in cfg.layer_pattern if k not in _KINDS]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {bad} are not ported (only {_KINDS})")
    if not cfg.embed_inputs or not cfg.use_rope or cfg.encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: frontend stubs, sinusoidal positions and "
            "encoder-decoder models are not ported")


def attn_cfg(cfg: ModelConfig, kind: str,
             index: Optional[int] = None) -> L.AttentionLayerCfg:
    """index: position within cfg.layer_pattern; when cfg.window_schedule
    names a window there, it overrides this layer's attention spec (sparse
    specs keep num_global/softcap; dense specs become causal swat
    windows)."""
    spec = cfg.local_attention if kind == "local_attn" else cfg.attention
    if (index is not None and cfg.window_schedule is not None
            and cfg.window_schedule[index] is not None):
        w = cfg.window_schedule[index]
        if spec.is_sparse:
            spec = dataclasses.replace(spec, window=w)
        else:
            spec = AttentionSpec(kind="swat", window=w, causal=spec.causal,
                                 softcap=spec.softcap)
    return L.AttentionLayerCfg(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
        spec=spec, qkv_bias=cfg.qkv_bias, rope_theta=cfg.rope_theta,
        use_rope=cfg.use_rope)


# ------------------------------------------------------------------ init ---

def init_model(cfg: ModelConfig, *, seed: int = 0,
               device="cuda") -> Params:
    """Random params from a seeded `torch.Generator` on `device`, with the
    JAX package's distributions (normal*0.02 embeddings, truncated-normal
    fan-in weights, zero norm scales). The values differ from the JAX
    package's for the same seed; parity tests convert JAX params instead
    (`interop.params_from_jax`)."""
    _check_supported(cfg)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = _dtype(cfg)
    params: Params = {
        "embed": (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                              device=device) * 0.02).to(dt)}
    blocks = []
    for _ in range(cfg.num_super_blocks):
        blk = {}
        for i, kind in enumerate(cfg.layer_pattern):
            p: Params = {"norm1": L.init_rmsnorm(cfg.d_model, device)}
            p["mixer"] = L.init_attention(gen, attn_cfg(cfg, kind, index=i),
                                          dt, device)
            if cfg.d_ff > 0:
                p["norm2"] = L.init_rmsnorm(cfg.d_model, device)
                p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dt, device)
            blk[f"l{i}"] = p
        blocks.append(blk)
    params["blocks"] = blocks
    params["final_norm"] = L.init_rmsnorm(cfg.d_model, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = (torch.randn((cfg.d_model, cfg.vocab_size),
                                         generator=gen, device=device)
                             * 0.02).to(dt)
    return params


# --------------------------------------------------------------- forward ---

def embed_tokens(params: Params, cfg: ModelConfig,
                 batch: Dict[str, Any]) -> torch.Tensor:
    x = params["embed"][batch["tokens"].long()]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _unembed(params: Params, cfg: ModelConfig, x) -> torch.Tensor:
    """fp32 logits. With bf16 weights the product accumulates in fp32 inside
    the matmul and is rounded to bf16 before the fp32 cast (PyTorch has no
    portable bf16 x bf16 -> fp32 product; an fp32 copy of the 128k x 2048
    head would double the unembed's bytes per decode step)."""
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = F.linear(x, params["embed"])
    else:
        logits = x @ params["lm_head"]
    return L.softcap(logits.float(), cfg.final_softcap)


def _ffn(p: Params, cfg: ModelConfig, x):
    if "mlp" in p:
        h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = x + L.mlp(p["mlp"], h)
    return x


def forward_logits(params: Params, cfg: ModelConfig, batch, *,
                   impl: Optional[str] = None) -> torch.Tensor:
    """Full-sequence logits (B, L, V), fp32."""
    _check_supported(cfg)
    x = embed_tokens(params, cfg, batch)
    for blk in params["blocks"]:
        for i, kind in enumerate(cfg.layer_pattern):
            p = blk[f"l{i}"]
            h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
            x = x + L.attention_layer(p["mixer"],
                                      attn_cfg(cfg, kind, index=i), h,
                                      impl=impl)
            x = _ffn(p, cfg, x)
    return _unembed(params, cfg, x)


# --------------------------------------------------------------- serving ---

def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                lookahead: int = 0, device="cuda") -> Caches:
    """Per-super-block decode caches (zeroed rings, step 0)."""
    _check_supported(cfg)
    return [{f"l{i}": L.init_kv_cache(attn_cfg(cfg, kind, index=i), batch,
                                      max_len, dtype=_dtype(cfg),
                                      lookahead=lookahead, device=device)
             for i, kind in enumerate(cfg.layer_pattern)}
            for _ in range(cfg.num_super_blocks)]


def decode_step(params: Params, cfg: ModelConfig, batch, caches: Caches, *,
                impl: Optional[str] = None, lookahead: int = 0):
    """T tokens for every sequence (usually T=1). batch: {"tokens": (B, T)}.
    Per-slot cache steps: rows may sit at different positions. T > 1 needs
    caches allocated with lookahead >= T-1. Caches update IN PLACE. Returns
    (logits (B, T, V) fp32, caches)."""
    _check_supported(cfg)
    x = embed_tokens(params, cfg, batch)
    b, t = batch["tokens"].shape
    # every layer's cache advances together, so the rope tables at
    # step + arange(T) and the per-slot row count are the same for all
    # layers: build them once per step (each is several launches)
    step = caches[0]["l0"]["step"]
    pos = step.long()[:, None, None] + torch.arange(t, device=step.device)
    rope = L.rope_tables(pos, cfg.resolved_head_dim, cfg.rope_theta)
    num_new = torch.full((b,), t, dtype=torch.int32, device=step.device)
    for blk, blk_cache in zip(params["blocks"], caches):
        for i, kind in enumerate(cfg.layer_pattern):
            p = blk[f"l{i}"]
            h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
            y, _ = L.attention_decode(p["mixer"],
                                      attn_cfg(cfg, kind, index=i), h,
                                      blk_cache[f"l{i}"], impl=impl,
                                      lookahead=lookahead, rope=rope,
                                      num_new=num_new)
            x = _ffn(p, cfg, x + y)
    return _unembed(params, cfg, x), caches


def prefill(params: Params, cfg: ModelConfig, batch, max_len: int, *,
            impl: Optional[str] = None, lengths=None, lookahead: int = 0):
    """Run the prompt, return (last-position logits (B, 1, V), primed
    caches). lengths: optional (B,) real prompt lengths of a right-padded
    batch — per-row cache steps, and logits gathered at each row's last
    real token. Causality makes the pad tail inert."""
    _check_supported(cfg)
    x = embed_tokens(params, cfg, batch)
    b, l, _ = x.shape
    caches: Caches = []
    for blk in params["blocks"]:
        new_caches = {}
        for i, kind in enumerate(cfg.layer_pattern):
            p = blk[f"l{i}"]
            acfg = attn_cfg(cfg, kind, index=i)
            h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
            y, k, v = L.attention_layer(p["mixer"], acfg, h, impl=impl,
                                        return_kv=True)
            new_caches[f"l{i}"] = L.prefill_kv_cache(
                acfg, k, v, max_len, lengths=lengths, lookahead=lookahead)
            x = _ffn(p, cfg, x + y)
        caches.append(new_caches)
    if lengths is None:
        last = x[:, -1:]
    else:
        idx = torch.clamp(lengths.to(x.device).long() - 1, 0, l - 1)
        last = x[torch.arange(b, device=x.device), idx][:, None]
    return _unembed(params, cfg, last), caches
