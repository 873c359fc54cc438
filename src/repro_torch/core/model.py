"""Attention-only decoder LM (the port of the JAX package's `core/model.py`
for the layer kinds "attn" and "local_attn").

Params are a plain dict with the JAX package's leaf layouts, except that
the stacked super-blocks (`blocks/l{i}/...` with a leading num_super_blocks
axis) are a Python list of per-super-block dicts (`interop.params_from_jax`
unstacks them). Caches follow the same rule: a list over super-blocks of
{"l{i}": ring cache}. Decode updates caches IN PLACE.

`impl` selects the attention implementation (see `kernels/ops.py`); the
default is the CUDA kernels for CUDA tensors and the plain versions for CPU
tensors. Training differentiates `loss_fn` with autograd, recomputing each
super-block in the backward pass under `REMAT_POLICIES`. Other layer kinds
(mamba, MoE, cross-attention) raise NotImplementedError: they belong to
later slices.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional

import torch
from torch.utils import checkpoint as ckpt

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


def _head_product(x2d: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """x2d @ head as the fp32-accumulated product, returned in fp32 and
    never rounded to the operands' dtype (the JAX package's
    preferred_element_type=float32). On CUDA without autograd it is one
    `aten::mm.dtype` call, which reads the bf16 head as it is; that op has
    no backward in PyTorch, so where autograd records (training) and on the
    CPU (which has no kernel for it) both operands are upcast to fp32."""
    recording = torch.is_grad_enabled() and (x2d.requires_grad
                                             or head.requires_grad)
    if x2d.is_cuda and x2d.dtype != torch.float32 and not recording:
        return torch.mm(x2d, head, out_dtype=torch.float32)
    return x2d.float() @ head.float()


def _unembed(params: Params, cfg: ModelConfig, x) -> torch.Tensor:
    """fp32 logits: the fp32-accumulated product of the final-normed
    activations and the (tied or separate) head, as in the JAX package."""
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = _head_product(x.reshape(-1, x.shape[-1]), head)
    logits = logits.reshape(*x.shape[:-1], head.shape[1])
    return L.softcap(logits, cfg.final_softcap)


def _ffn(p: Params, cfg: ModelConfig, x):
    if "mlp" in p:
        h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = x + L.mlp(p["mlp"], h)
    return x


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy: keep the outputs of 2-D matrix products
    (the projections and the MLP, `x @ W`), recompute everything else —
    the JAX package's checkpoint_dots_with_no_batch_dims."""
    if op in _SAVED_DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


REMAT_POLICIES = {
    # recompute the whole super-block in the backward pass: least live
    # memory, most recompute
    "nothing": None,
    # save the matmul outputs: more activation memory, no recompute of the
    # heavy products
    "dots": _save_dots,
}


def _stack_forward(blocks, cfg: ModelConfig, x, *, impl: Optional[str],
                   remat: bool, remat_policy: str = "nothing"):
    """Run every super-block. With `remat` (and autograd recording), each
    super-block is a `torch.utils.checkpoint` region under
    REMAT_POLICIES[remat_policy]: its activations are recomputed in the
    backward pass (the JAX package's jax.checkpoint around the scan body)."""
    policy = REMAT_POLICIES[remat_policy]

    def block_fn(x, blk):
        for i, kind in enumerate(cfg.layer_pattern):
            p = blk[f"l{i}"]
            h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
            x = x + L.attention_layer(p["mixer"],
                                      attn_cfg(cfg, kind, index=i), h,
                                      impl=impl)
            x = _ffn(p, cfg, x)
        return x

    kw = {}
    if policy is not None:
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, policy)
    for blk in blocks:
        if remat and torch.is_grad_enabled():
            x = ckpt.checkpoint(block_fn, x, blk, use_reentrant=False, **kw)
        else:
            x = block_fn(x, blk)
    return x


def forward_logits(params: Params, cfg: ModelConfig, batch, *,
                   impl: Optional[str] = None, remat: bool = False,
                   remat_policy: str = "nothing") -> torch.Tensor:
    """Full-sequence logits (B, L, V), fp32. `remat` recomputes each
    super-block in the backward pass (training); serving leaves it off."""
    _check_supported(cfg)
    x = embed_tokens(params, cfg, batch)
    x = _stack_forward(params["blocks"], cfg, x, impl=impl, remat=remat,
                       remat_policy=remat_policy)
    return _unembed(params, cfg, x)


def loss_fn(params: Params, cfg: ModelConfig, batch, *,
            impl: Optional[str] = None, remat: bool = True,
            aux_weight: float = 0.01, remat_policy: str = "nothing"):
    """Next-token cross entropy in fp32. batch["labels"]: (B, L) int;
    positions with label < 0 are masked out. Returns (total, {"loss",
    "aux_loss", "tokens"}) as 0-dim tensors; aux is zero for the ported
    (attention-only) layer kinds."""
    logits = forward_logits(params, cfg, batch, impl=impl, remat=remat,
                            remat_policy=remat_policy)
    labels = batch["labels"].long()
    logits = logits[:, :-1].float()
    targets = labels[:, 1:]
    valid = targets >= 0
    tsafe = torch.where(valid, targets, 0)
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, tsafe[..., None])[..., 0]
    nll = torch.where(valid, lse - picked, 0.0)
    denom = torch.clamp(valid.sum(), min=1)
    loss = nll.sum() / denom
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux_loss": aux,
                   "tokens": denom.to(torch.float32)}


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
