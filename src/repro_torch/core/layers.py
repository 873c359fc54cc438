"""Attention-only layers: norms, rotary embeddings, GQA attention, MLP and
the ring KV cache (the port of the JAX package's `core/layers.py`).

Parameters are plain dicts of tensors with the JAX package's layouts
(`x @ W` weights of shape (d_in, d_out)); attention tensors are
(B, H, L, D); ring caches are (B, Hkv, W, D) with a per-slot (B,) int32
`step`. Decode updates a cache IN PLACE (the tensors of the dict it is
given, and its `step`), where the JAX engine donated the cache buffers; a
prefill chunk replaces the dict's k/v entries and step.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.types import AttentionSpec
from repro_torch.kernels import ops as kops

Params = Dict[str, Any]


def _dense_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """Truncated normal on [-2, 2] times sqrt(1/fan_in), by inverse CDF."""
    scale = (1.0 / shape[0]) ** 0.5
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    u = lo + (1.0 - 2.0 * lo) * u
    x = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return (x.clamp_(-2.0, 2.0) * scale).to(dtype)


# ---------------------------------------------------------------- norms ----

def init_rmsnorm(d: int, device) -> Params:
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6):
    """(1 + scale) parametrization, fp32 math."""
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + params["scale"])).to(dtype)


# ----------------------------------------------------------------- rope ----

def rope_frequencies(head_dim: int, theta: float, device=None):
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(sin, cos) of the rotation angles, each (..., L, D/2) fp32, for
    positions (..., L) or (L,). Computed once and shared by q and k (and, in
    decode, by every layer)."""
    freqs = rope_frequencies(head_dim, theta, positions.device)  # (D/2,)
    angles = positions[..., None].float() * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, positions: Optional[torch.Tensor] = None,
               theta: Optional[float] = None, *, tables=None):
    """x: (..., L, D) with positions (..., L) or (L,), or precomputed
    `tables` from `rope_tables`. Split-half rotation: the first half of the
    head dim pairs with the second half, (x[i], x[i + D/2]) for i < D/2
    (llama / NeoX convention)."""
    sin, cos = (rope_tables(positions, x.shape[-1], theta) if tables is None
                else tables)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=32)
def sinusoidal_positions(length: int, d: int, device=None) -> torch.Tensor:
    """(length, d) fp32 absolute position table (whisper): sin in the even
    columns, cos in the odd ones, angle pos / 10000^(2i/d). Built once per
    (length, d, device): decode adds it on every step. Callers must not
    write to it."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, dim / d)
    pe = torch.zeros((length, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return pe


# ------------------------------------------------------------ attention ----

@dataclasses.dataclass(frozen=True)
class AttentionLayerCfg:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    spec: AttentionSpec
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    cross: bool = False          # cross-attention (whisper decoder)


def init_attention(gen: torch.Generator, cfg: AttentionLayerCfg, dtype,
                   device) -> Params:
    dm, hq, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": _dense_init(gen, (dm, hq * dh), dtype, device),
         "wk": _dense_init(gen, (dm, hkv * dh), dtype, device),
         "wv": _dense_init(gen, (dm, hkv * dh), dtype, device),
         "wo": _dense_init(gen, (hq * dh, dm), dtype, device)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq * dh,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((hkv * dh,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((hkv * dh,), dtype=dtype, device=device)
    return p


def _project_qkv(params: Params, cfg: AttentionLayerCfg, x, kv_x):
    b, l, _ = x.shape
    lkv = kv_x.shape[1]
    q = x @ params["wq"]
    k = kv_x @ params["wk"]
    v = kv_x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(b, l, cfg.num_heads, cfg.head_dim).transpose(1, 2)
    k = k.reshape(b, lkv, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    v = v.reshape(b, lkv, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    return q.contiguous(), k.contiguous(), v.contiguous()


def attention_layer(params: Params, cfg: AttentionLayerCfg, x, *,
                    kv_x=None, positions=None, impl: Optional[str] = None,
                    return_kv: bool = False):
    """Full-sequence attention (prefill, training). x: (B, L, Dm); kv_x:
    (B, Lkv, Dm) for cross attention (defaults to x). With `return_kv`,
    returns (out, k, v) with the (roped, for rotary self-attention) k and v
    (B, Hkv, Lkv, D) that `prefill_kv_cache` stores, or the cross cache
    holds, so prefill projects each layer once."""
    b, l, _ = x.shape
    kv_x = x if kv_x is None else kv_x
    q, k, v = _project_qkv(params, cfg, x, kv_x)
    if cfg.use_rope and not cfg.cross:
        pos = (torch.arange(l, device=x.device) if positions is None
               else positions)
        rope = rope_tables(pos, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, tables=rope)
        k = apply_rope(k, tables=rope)
    out = kops.swat_attention(q, k, v, cfg.spec, impl=impl)
    out = out.transpose(1, 2).reshape(b, l, -1) @ params["wo"]
    return (out, k, v) if return_kv else out


def cross_attention_decode(params: Params, cfg: AttentionLayerCfg, x, cache,
                           enc_len: torch.Tensor, *,
                           impl: Optional[str] = None):
    """Cross-attention of T decoder tokens over the encoder's K/V held in
    `cache` ("xk"/"xv", (B, Hkv, Lenc, D)). x: (B, T, Dm); enc_len: (B,)
    int32 encoder rows per slot. A plain-mode `decode_attention` (the
    plain decode CUDA kernel on the card). Returns (B, T, Dm)."""
    b, t, _ = x.shape
    q = x @ params["wq"]
    if cfg.qkv_bias:
        q = q + params["bq"]
    q = q.reshape(b, t, cfg.num_heads, cfg.head_dim).transpose(1, 2)
    out = kops.decode_attention(q.contiguous(), cache["xk"], cache["xv"],
                                enc_len, cfg.spec, impl=impl)
    return out.transpose(1, 2).reshape(b, t, -1) @ params["wo"]


# KV cache ------------------------------------------------------------------

def _round_capacity(cap: int) -> int:
    """Round a ring ALLOCATION up to a tile quantum (16 for small rings, 64
    above): the same physical allocation law as the JAX package, so cache
    tensors compare element for element. Rows past the logical capacity
    stay zero and masked."""
    q = 64 if cap > 64 else 16
    return -(-cap // q) * q


def cache_capacity(cfg: AttentionLayerCfg, max_len: int,
                   lookahead: int = 0) -> int:
    """LOGICAL ring capacity: window+1(+lookahead)(+globals) for sparse
    attention, full context for dense. `max_len` may be a physical
    allocation width: the logical capacity is recoverable from it."""
    if cfg.spec.is_sparse:
        cap = cfg.spec.window + 1 + lookahead + cfg.spec.num_global
        return min(cap, max_len)
    return max_len


def cache_allocation(cfg: AttentionLayerCfg, max_len: int,
                     lookahead: int = 0) -> int:
    """PHYSICAL rows allocated for the ring: the logical capacity rounded up
    to a tile quantum (clamped to max_len)."""
    cap = cache_capacity(cfg, max_len, lookahead)
    if cfg.spec.is_sparse:
        return min(_round_capacity(cap), max_len)
    return cap


def init_kv_cache(cfg: AttentionLayerCfg, batch: int, max_len: int,
                  dtype=torch.bfloat16, lookahead: int = 0, device=None):
    """Ring KV cache with a PER-SLOT write pointer `step` (batch,) int32,
    allocated at `cache_allocation` width."""
    cap = cache_allocation(cfg, max_len, lookahead)
    shape = (batch, cfg.num_kv_heads, cap, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "step": torch.zeros((batch,), dtype=torch.int32, device=device)}


def ring_scatter(cache_kv, new, positions, write, g: int, ring: int):
    """Write `new` (B, H, T, D) rows into their ring slots of a cache
    (B, H, cap, D). positions: (T,) absolute token indices shared by every
    row; write: (B, T) bool, which tokens are real for each row. Per (row,
    slot) the highest-index writer wins, so a span longer than the ring and
    per-row ragged lengths both resolve as sequential FIFO insertion would.
    Returns a new tensor (a gather of the winning rows: exact in any
    dtype)."""
    b, h, cap, d = cache_kv.shape
    t = new.shape[2]
    positions = positions.long()
    slot = torch.where(positions < g, positions,
                       g + torch.remainder(positions - g, ring))
    jidx = torch.arange(t, device=new.device)
    hit = slot[:, None] == torch.arange(cap, device=new.device)[None, :]
    cand = torch.where(write[:, :, None] & hit[None], jidx[None, :, None], -1)
    winner = cand.amax(dim=1)                                      # (B, cap)
    src = winner.clamp(min=0)[:, None, :, None].expand(b, h, cap, d)
    upd = torch.gather(new.to(cache_kv.dtype), 2, src)
    return torch.where((winner >= 0)[:, None, :, None], upd, cache_kv)


def prefill_kv_cache(cfg: AttentionLayerCfg, k, v, max_len: int,
                     lengths=None, lookahead: int = 0):
    """Fill a cache from a prompt's roped K and V (B, Hkv, L, D), as
    `attention_layer(..., return_kv=True)` gives them (the JAX package's
    version takes the layer input and projects it again; its jit removes
    the repeat, eager PyTorch would not). For ring caches only the last
    `cap` tokens are retained. lengths: optional (B,) real prompt lengths
    of a right-padded batch: rows write only their first lengths[i] tokens
    and the cache step is set per row."""
    b, _, l, _ = k.shape
    dev = k.device
    cap = cache_capacity(cfg, max_len, lookahead)
    cache = init_kv_cache(cfg, b, max_len, dtype=k.dtype,
                          lookahead=lookahead, device=dev)
    g = cfg.spec.num_global if cfg.spec.is_sparse else 0
    lens = (torch.full((b,), l, dtype=torch.int32, device=dev)
            if lengths is None else lengths.to(device=dev, dtype=torch.int32))
    if l <= cap:
        # no wrap possible: natural slots; pad rows above a row's step are
        # masked and overwritten one for one as decode advances
        cache["k"][:, :, :l] = k
        cache["v"][:, :, :l] = v
    else:
        write = torch.arange(l, device=dev)[None, :] < lens[:, None]
        tok = torch.arange(l, device=dev)
        cache["k"] = ring_scatter(cache["k"], k, tok, write, g, cap - g)
        cache["v"] = ring_scatter(cache["v"], v, tok, write, g, cap - g)
    cache["step"] = lens.clone()
    return cache


def attention_decode(params: Params, cfg: AttentionLayerCfg, x, cache, *,
                     impl: Optional[str] = None, lookahead: int = 0,
                     rope=None, num_new=None):
    """T-token decode. x: (B, T, Dm). The ring insert (at each slot's own
    `step`) and the window attention run in one `decode_attention` call —
    the fused CUDA kernel on the card. `rope` (tables of `rope_tables` at
    positions step + arange(T)) and `num_new` ((B,) int32) may be computed
    once per step by the caller and shared by every layer. Updates `cache`
    IN PLACE (its k/v tensors and step) and returns (out (B, T, Dm),
    cache)."""
    b, t, _ = x.shape
    q, k_new, v_new = _project_qkv(params, cfg, x, x)
    step = cache["step"]
    if cfg.use_rope:
        if rope is None:
            pos = (step.long()[:, None, None]
                   + torch.arange(t, device=x.device))         # (B, 1, T)
            rope = rope_tables(pos, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, tables=rope)
        k_new = apply_rope(k_new, tables=rope)
    # rotate and mask at the LOGICAL capacity: the tile-rounding tail of the
    # allocation is never written or attended
    cap = cache_capacity(cfg, cache["k"].shape[2], lookahead)
    g = cfg.spec.num_global if cfg.spec.is_sparse else 0
    if t > 1 and cfg.spec.is_sparse and cap - g < cfg.spec.window + t:
        raise ValueError(f"T={t} decode on a {cap - g}-row ring would evict "
                         "in-window tokens: allocate caches with "
                         "lookahead >= T-1")
    out, _, _ = kops.decode_attention(
        q, cache["k"], cache["v"], None, cfg.spec, impl=impl,
        new_kv=(k_new, v_new), num_new=num_new, pos=step, ring_cap=cap)
    cache["step"] = step + t
    out = out.transpose(1, 2).reshape(b, t, -1)
    return out @ params["wo"], cache


def attention_prefill_chunk(params: Params, cfg: AttentionLayerCfg, x, cache,
                            pos0: int, lengths, *, impl: Optional[str] = None,
                            lookahead: int = 0, rope=None):
    """One chunk of a batched chunked prefill: tokens [pos0, pos0+T) of
    every row attend the ring cache (every earlier chunk) plus the chunk
    itself (`kops.prefill_chunk_attention`: the banded forward with offsets
    on the card), then the chunk's K/V go into their ring slots. Exact: the
    ring holds every token a band query can still see, so the chunks
    compute single-shot prefill's function while scores stay (T, cap+T).
    pos0 is shared by every row; lengths (B,) stop each row's writes at its
    own length (outputs past it are garbage the caller drops). `rope`:
    tables of `rope_tables` at pos0 + arange(T), shared by every layer.
    Updates `cache` IN PLACE (its k/v entries and step = min(lengths,
    pos0+T)) and returns (out (B, T, Dm), cache). Causal specs only."""
    if not cfg.spec.causal or cfg.cross:
        raise ValueError("prefill chunks need causal self-attention")
    b, t, _ = x.shape
    q, k_new, v_new = _project_qkv(params, cfg, x, x)
    pos = pos0 + torch.arange(t, device=x.device)
    if cfg.use_rope:
        if rope is None:
            rope = rope_tables(pos, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, tables=rope)
        k_new = apply_rope(k_new, tables=rope)
    cap = cache_capacity(cfg, cache["k"].shape[2], lookahead)
    g = cfg.spec.num_global if cfg.spec.is_sparse else 0
    lens = lengths.to(device=x.device, dtype=torch.int32)
    out = kops.prefill_chunk_attention(
        q, k_new, v_new, cache["k"], cache["v"], cfg.spec, pos0, lens,
        ring_cap=cap, impl=impl)
    write = pos[None, :] < lens[:, None]                         # (B, T)
    cache["k"] = ring_scatter(cache["k"], k_new, pos, write, g, cap - g)
    cache["v"] = ring_scatter(cache["v"], v_new, pos, write, g, cap - g)
    cache["step"] = torch.clamp(lens, max=pos0 + t)
    out = out.transpose(1, 2).reshape(b, t, -1)
    return out @ params["wo"], cache


# ---------------------------------------------------------------- mlp ------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype, device,
             gated: bool = True) -> Params:
    p = {"w1": _dense_init(gen, (d_model, d_ff), dtype, device),
         "w2": _dense_init(gen, (d_ff, d_model), dtype, device)}
    if gated:
        p["w3"] = _dense_init(gen, (d_model, d_ff), dtype, device)
    return p


def mlp(params: Params, x):
    """Gated SiLU MLP (the only activation the ported configs use)."""
    h = F.silu(x @ params["w1"])
    if "w3" in params:
        h = h * (x @ params["w3"])
    return h @ params["w2"]


def softcap(x, cap: float):
    return cap * torch.tanh(x / cap) if cap else x
