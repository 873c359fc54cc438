"""Attention decoder LMs and the whisper encoder-decoder (the port of the
JAX package's `core/model.py` for the layer kinds "attn", "local_attn" and
"xattn").

Params are a plain dict with the JAX package's leaf layouts, except that
the stacked super-blocks (`blocks/l{i}/...` and `enc_blocks/l0/...`, each
with a leading num_super_blocks axis) are Python lists of per-super-block
dicts (`interop.params_from_jax` unstacks them). Caches follow the same
rule: a list over super-blocks of {"l{i}": ring cache}; an "xattn" layer's
cache also holds the encoder's cross K/V ("xk", "xv"). Decode updates
caches IN PLACE.

`impl` selects the attention implementation (see `kernels/ops.py`); the
default is the CUDA kernels for CUDA tensors and the plain versions for CPU
tensors. Training differentiates `loss_fn` with autograd, recomputing each
super-block in the backward pass under `REMAT_POLICIES`; `prefill`,
`prefill_chunk` and `decode_step` run without autograd. The layer kinds
"mamba*" and "*_moe" raise NotImplementedError: they belong to later
slices.
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
_KINDS = ("attn", "local_attn", "xattn")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_supported(cfg: ModelConfig) -> None:
    bad = [k for k in cfg.layer_pattern if k not in _KINDS]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {bad} are not ported (only {_KINDS})")


def attn_cfg(cfg: ModelConfig, kind: str, cross: bool = False,
             index: Optional[int] = None) -> L.AttentionLayerCfg:
    """cross: the whisper decoder's cross-attention (dense, non-causal).
    index: position within cfg.layer_pattern; when cfg.window_schedule
    names a window there, it overrides this layer's attention spec (sparse
    specs keep num_global/softcap; dense specs become causal swat
    windows)."""
    spec = cfg.local_attention if kind == "local_attn" else cfg.attention
    if cross:
        spec = AttentionSpec(kind="dense", causal=False)
    elif (index is not None and cfg.window_schedule is not None
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
        use_rope=cfg.use_rope, cross=cross)


@functools.lru_cache(maxsize=64)
def cfg_encoder(cfg: ModelConfig) -> ModelConfig:
    """Whisper encoder: bidirectional self-attention, no causality."""
    return dataclasses.replace(
        cfg, layer_pattern=("attn",), use_rope=False, window_schedule=None,
        attention=dataclasses.replace(cfg.attention, causal=False))


# ------------------------------------------------------------------ init ---

def _init_super_block(gen: torch.Generator, cfg: ModelConfig, dt,
                      device) -> Params:
    blk = {}
    for i, kind in enumerate(cfg.layer_pattern):
        p: Params = {"norm1": L.init_rmsnorm(cfg.d_model, device)}
        p["mixer"] = L.init_attention(gen, attn_cfg(cfg, kind, index=i), dt,
                                      device)
        if kind == "xattn":
            p["norm_x"] = L.init_rmsnorm(cfg.d_model, device)
            p["cross"] = L.init_attention(
                gen, attn_cfg(cfg, kind, cross=True), dt, device)
        if cfg.d_ff > 0:
            p["norm2"] = L.init_rmsnorm(cfg.d_model, device)
            p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dt, device)
        blk[f"l{i}"] = p
    return blk


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
    params: Params = {}
    if cfg.embed_inputs:
        params["embed"] = (torch.randn((cfg.vocab_size, cfg.d_model),
                                       generator=gen, device=device)
                           * 0.02).to(dt)
    params["blocks"] = [_init_super_block(gen, cfg, dt, device)
                        for _ in range(cfg.num_super_blocks)]
    params["final_norm"] = L.init_rmsnorm(cfg.d_model, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = (torch.randn((cfg.d_model, cfg.vocab_size),
                                         generator=gen, device=device)
                             * 0.02).to(dt)
    if cfg.encoder_decoder:
        ecfg = cfg_encoder(cfg)
        params["enc_blocks"] = [_init_super_block(gen, ecfg, dt, device)
                                for _ in range(cfg.encoder_layers)]
        params["enc_norm"] = L.init_rmsnorm(cfg.d_model, device)
    return params


# --------------------------------------------------------------- forward ---

def embed_tokens(params: Params, cfg: ModelConfig,
                 batch: Dict[str, Any]) -> torch.Tensor:
    """Token embeddings, or the precomputed `"embeddings"` of a frontend
    stub (VLM patches, audio frames) cast to the model dtype; sinusoidal
    absolute positions are added when the config has no rope (whisper)."""
    if "embeddings" in batch:
        x = batch["embeddings"].to(_dtype(cfg))
    elif cfg.embed_inputs:
        x = params["embed"][batch["tokens"].long()]
    else:
        raise ValueError("batch needs 'tokens' or 'embeddings'")
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if not cfg.use_rope:
        x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model,
                                       x.device).to(x.dtype)[None]
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
                   remat: bool, remat_policy: str = "nothing",
                   enc_out=None):
    """Run every super-block (enc_out: the encoder's output, which "xattn"
    layers attend). With `remat` (and autograd recording), each
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
            if kind == "xattn":
                h = L.rmsnorm(p["norm_x"], x, cfg.norm_eps)
                x = x + L.attention_layer(p["cross"],
                                          attn_cfg(cfg, kind, cross=True), h,
                                          kv_x=enc_out, impl=impl)
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


def encode(params: Params, cfg: ModelConfig, batch, *,
           impl: Optional[str] = None) -> torch.Tensor:
    """Whisper encoder over precomputed frame embeddings
    (batch["enc_embeddings"], (B, Lenc, Dm); the conv frontend is a stub):
    sinusoidal positions, the bidirectional (SWAT band, under with_swat)
    self-attention stack, final norm."""
    x = batch["enc_embeddings"].to(_dtype(cfg))
    x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model,
                                   x.device).to(x.dtype)[None]
    x = _stack_forward(params["enc_blocks"], cfg_encoder(cfg), x, impl=impl,
                       remat=False)
    return L.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def forward_logits(params: Params, cfg: ModelConfig, batch, *,
                   impl: Optional[str] = None, remat: bool = False,
                   remat_policy: str = "nothing") -> torch.Tensor:
    """Full-sequence logits (B, L, V), fp32. `remat` recomputes each
    super-block in the backward pass (training); serving leaves it off."""
    _check_supported(cfg)
    enc_out = (encode(params, cfg, batch, impl=impl)
               if cfg.encoder_decoder else None)
    x = embed_tokens(params, cfg, batch)
    x = _stack_forward(params["blocks"], cfg, x, impl=impl, remat=remat,
                       remat_policy=remat_policy, enc_out=enc_out)
    return _unembed(params, cfg, x)


def loss_fn(params: Params, cfg: ModelConfig, batch, *,
            impl: Optional[str] = None, remat: bool = True,
            aux_weight: float = 0.01, remat_policy: str = "nothing"):
    """Next-token cross entropy in fp32. batch["labels"]: (B, L) int;
    positions with label < 0 are masked out. Returns (total, {"loss",
    "aux_loss", "tokens"}) as 0-dim tensors; aux is zero for the ported
    layer kinds (no MoE)."""
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
                enc_len: int = 0, lookahead: int = 0,
                device="cuda") -> Caches:
    """Per-super-block decode caches (zeroed rings, step 0); "xattn" layers
    also get zeroed cross K/V ("xk", "xv") of max(enc_len, 1) rows."""
    _check_supported(cfg)
    dt = _dtype(cfg)

    def layer(i, kind):
        cache = L.init_kv_cache(attn_cfg(cfg, kind, index=i), batch, max_len,
                                dtype=dt, lookahead=lookahead, device=device)
        if kind == "xattn":
            shape = (batch, cfg.num_kv_heads, max(enc_len, 1),
                     cfg.resolved_head_dim)
            cache["xk"] = torch.zeros(shape, dtype=dt, device=device)
            cache["xv"] = torch.zeros(shape, dtype=dt, device=device)
        return cache

    return [{f"l{i}": layer(i, kind)
             for i, kind in enumerate(cfg.layer_pattern)}
            for _ in range(cfg.num_super_blocks)]


@torch.no_grad()
def decode_step(params: Params, cfg: ModelConfig, batch, caches: Caches, *,
                impl: Optional[str] = None, lookahead: int = 0):
    """T tokens for every sequence (usually T=1). batch: {"tokens": (B, T)}
    (or {"embeddings": (B, T, Dm)}). Per-slot cache steps: rows may sit at
    different positions. T > 1 needs caches allocated with lookahead >=
    T-1. "xattn" layers attend the cross K/V that prefill stored. Caches
    update IN PLACE. Runs without autograd. Returns (logits (B, T, V)
    fp32, caches)."""
    _check_supported(cfg)
    x = embed_tokens(params, cfg, batch)
    b, t = x.shape[:2]
    # every layer's cache advances together, so the rope tables at
    # step + arange(T), the per-slot row count and the encoder length are
    # the same for all layers: build them once per step (each is several
    # launches)
    first = caches[0]["l0"]
    step = first["step"]
    rope = None
    if cfg.use_rope:
        pos = step.long()[:, None, None] + torch.arange(t, device=step.device)
        rope = L.rope_tables(pos, cfg.resolved_head_dim, cfg.rope_theta)
    num_new = torch.full((b,), t, dtype=torch.int32, device=step.device)
    enc_len = (torch.full((b,), first["xk"].shape[2], dtype=torch.int32,
                          device=step.device) if "xk" in first else None)
    for blk, blk_cache in zip(params["blocks"], caches):
        for i, kind in enumerate(cfg.layer_pattern):
            p, cache = blk[f"l{i}"], blk_cache[f"l{i}"]
            h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
            y, _ = L.attention_decode(p["mixer"],
                                      attn_cfg(cfg, kind, index=i), h,
                                      cache, impl=impl, lookahead=lookahead,
                                      rope=rope, num_new=num_new)
            x = x + y
            if kind == "xattn":
                h = L.rmsnorm(p["norm_x"], x, cfg.norm_eps)
                x = x + L.cross_attention_decode(
                    p["cross"], attn_cfg(cfg, kind, cross=True), h, cache,
                    enc_len, impl=impl)
            x = _ffn(p, cfg, x)
    return _unembed(params, cfg, x), caches


def prefill_chunkable(cfg: ModelConfig) -> bool:
    """Whether `prefill_chunk` supports this config: rotary attention-only
    patterns (mamba carries state between chunks; xattn and sinusoidal
    positions take the single-shot path). The engine's chunking switch."""
    return cfg.use_rope and all(
        not k.startswith("mamba") and k != "xattn"
        for k in cfg.layer_pattern)


def speculative_supported(cfg: ModelConfig) -> bool:
    """Whether the engine may decode speculatively: every layer's decode
    state is a ring KV cache whose `step` rolls back after a rejected
    draft (mamba's recurrent state and xattn's encoder memory have no such
    rollback), and positions are rotary, so a (B, T) verify step is
    position-exact. The engine's `speculative=` gate."""
    return prefill_chunkable(cfg)


@torch.no_grad()
def prefill_chunk(params: Params, cfg: ModelConfig, batch, caches: Caches,
                  pos0: int, lengths, *, impl: Optional[str] = None,
                  lookahead: int = 0) -> torch.Tensor:
    """One lockstep chunk of a batched chunked prefill: tokens [pos0,
    pos0+T) of every row through the stack against the ring caches, which
    take the chunk's K/V IN PLACE. Equal to single-shot `prefill` on the
    band, with per-layer scores of O(T * (cap + T)). lengths: (B,) real
    prompt lengths. Returns the hidden states (B, T, Dm): unembedding is
    the caller's, which gathers the one last-real-token row per sequence
    first. Runs without autograd."""
    if not prefill_chunkable(cfg):
        raise ValueError(f"{cfg.name}: prefill chunks need rotary "
                         f"attention-only layers, not {cfg.layer_pattern}")
    _check_supported(cfg)
    x = embed_tokens(params, cfg, batch)
    t = x.shape[1]
    # every layer shares the chunk's positions: one set of rope tables
    pos = pos0 + torch.arange(t, device=x.device)
    rope = L.rope_tables(pos, cfg.resolved_head_dim, cfg.rope_theta)
    for blk, blk_cache in zip(params["blocks"], caches):
        for i, kind in enumerate(cfg.layer_pattern):
            p = blk[f"l{i}"]
            h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
            y, _ = L.attention_prefill_chunk(
                p["mixer"], attn_cfg(cfg, kind, index=i), h,
                blk_cache[f"l{i}"], pos0, lengths, impl=impl,
                lookahead=lookahead, rope=rope)
            x = _ffn(p, cfg, x + y)
    return x


@torch.no_grad()
def prefill(params: Params, cfg: ModelConfig, batch, max_len: int, *,
            impl: Optional[str] = None, lengths=None, lookahead: int = 0):
    """Run the prompt, return (last-position logits (B, 1, V), primed
    caches). lengths: optional (B,) real prompt lengths of a right-padded
    batch — per-row cache steps, and logits gathered at each row's last
    real token. Causality makes the pad tail inert. Encoder-decoder
    configs run the encoder over batch["enc_embeddings"] first, and each
    "xattn" layer stores the encoder's cross K/V in its cache ("xk",
    "xv"); they take no `lengths`, as in the JAX package. Runs without
    autograd."""
    _check_supported(cfg)
    if lengths is not None and cfg.encoder_decoder:
        raise ValueError("padded prefill: decoder-only models")
    enc_out = (encode(params, cfg, batch, impl=impl)
               if cfg.encoder_decoder else None)
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
            cache = L.prefill_kv_cache(acfg, k, v, max_len, lengths=lengths,
                                       lookahead=lookahead)
            x = x + y
            if kind == "xattn":
                h = L.rmsnorm(p["norm_x"], x, cfg.norm_eps)
                y, cache["xk"], cache["xv"] = L.attention_layer(
                    p["cross"], attn_cfg(cfg, kind, cross=True), h,
                    kv_x=enc_out, impl=impl, return_kv=True)
                x = x + y
            new_caches[f"l{i}"] = cache
            x = _ffn(p, cfg, x)
        caches.append(new_caches)
    if lengths is None:
        last = x[:, -1:]
    else:
        idx = torch.clamp(lengths.to(x.device).long() - 1, 0, l - 1)
        last = x[torch.arange(b, device=x.device), idx][:, None]
    return _unembed(params, cfg, last), caches
