"""Decoder LMs (attention, MoE, Mamba2 and hybrid stacks) and the whisper
encoder-decoder (the port of the JAX package's `core/model.py`, every layer
kind: "attn", "attn_moe", "local_attn", "mamba", "mamba_moe", "xattn").

Params are a plain dict with the JAX package's leaf layouts, except that
the stacked super-blocks (`blocks/l{i}/...` and `enc_blocks/l0/...`, each
with a leading num_super_blocks axis) are Python lists of per-super-block
dicts (`interop.params_from_jax` unstacks them). Caches follow the same
rule: a list over super-blocks of {"l{i}": ring cache} (or, for the paged
layout, block pools and a table shared by every super-block); an "xattn"
layer's cache also holds the encoder's cross K/V ("xk", "xv"). Decode
updates caches IN PLACE.

`impl` selects the attention implementation (see `kernels/ops.py`); the
default is the CUDA kernels for CUDA tensors and the plain versions for CPU
tensors. Training differentiates `loss_fn` with autograd, recomputing each
super-block in the backward pass under `REMAT_POLICIES`; `prefill`,
`prefill_chunk` and `decode_step` run without autograd.

An "attn_moe" layer replaces the dense MLP with `core/moe.py`'s expert FFN
(`d_ff` is then each expert's width). Training and `forward_logits` run
the spec's dispatch ("sort") and `loss_fn` adds the summed Switch aux loss
at `aux_weight`; the serving sites (`prefill`, `prefill_chunk`,
`decode_step`) run the "dense" dispatch without the aux loss, as the JAX
package does (there it is computed and discarded).

A "mamba" or "mamba_moe" layer's mixer is `core/ssm.py`'s Mamba2 block
(with a dense MLP or the experts after it, by the same rule as attention
layers). Its decode state is the fixed conv window and SSM state of
`ssm.init_mamba_cache` in both cache layouts (never paged); `prefill`
stops each row's state at its own length, and `decode_step` advances it
one token at a time (T > 1 raises on a config with a mamba layer). Such
configs are neither chunkable nor speculative.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.core import layers as L
from repro_torch.core import moe as M
from repro_torch.core import ssm as S
from repro_torch.core.types import AttentionSpec, ModelConfig
from repro_torch.kernels import dots
from repro_torch.kernels import ops as kops
from repro_torch.kernels import swat_decode

Params = Dict[str, Any]
Caches = List[Dict[str, Dict[str, torch.Tensor]]]
_KINDS = ("attn", "attn_moe", "local_attn", "mamba", "mamba_moe", "xattn")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _is_mamba(kind: str) -> bool:
    return kind.startswith("mamba")


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
        if _is_mamba(kind):
            p["mixer"] = S.init_mamba(gen, cfg.d_model, cfg.ssm, dt, device)
        else:
            p["mixer"] = L.init_attention(gen, attn_cfg(cfg, kind, index=i),
                                          dt, device)
        if kind == "xattn":
            p["norm_x"] = L.init_rmsnorm(cfg.d_model, device)
            p["cross"] = L.init_attention(
                gen, attn_cfg(cfg, kind, cross=True), dt, device)
        if kind.endswith("_moe"):
            p["norm2"] = L.init_rmsnorm(cfg.d_model, device)
            p["moe"] = M.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.moe, dt,
                                  device)
        elif cfg.d_ff > 0:
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
    (`interop.params_from_jax`). On the meta device: the shapes only."""
    _check_supported(cfg)
    device = torch.device(device)
    # the meta device (shapes only, for placement plans) has no generator
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
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

def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 lo: Optional[int] = None) -> torch.Tensor:
    """The rows of `table` (V, Dm) for `tokens`. With `lo`, the table is a
    vocab shard holding rows [lo, lo + V) (a mesh's vocab-parallel lookup,
    summed over the shards): a token outside it gives a zero row.

    The lookup is `F.embedding`: its backward sums a token's duplicate rows
    in fp32 and rounds once, where the indexing's backward on CUDA rounds a
    bf16 table's gradient after every duplicate and loses the small
    additions of a frequent token."""
    t = tokens.long()
    if lo is None:
        return torch.nn.functional.embedding(t, table)
    v = table.shape[0]
    t = t - lo
    hit = (t >= 0) & (t < v)
    return (torch.nn.functional.embedding(t.clamp(0, v - 1), table)
            * hit[..., None].to(table.dtype))


def embed_tokens(params: Params, cfg: ModelConfig,
                 batch: Dict[str, Any],
                 rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings (`embed_lookup`), or the precomputed `"embeddings"`
    of a frontend stub (VLM patches, audio frames) cast to the model dtype;
    sinusoidal absolute positions are added when the config has no rope
    (whisper). rows: the tokens' looked-up rows, where the caller made them
    (a mesh's lookup over its table's shards)."""
    if "embeddings" in batch:
        x = batch["embeddings"].to(_dtype(cfg))
    elif rows is not None:
        x = rows
    elif cfg.embed_inputs:
        x = embed_lookup(params["embed"], batch["tokens"])
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
    CPU (which has no kernel for it) both operands are upcast to fp32. With
    `dots.native_mixed_dot` on (the dry-run), off the CPU, it is always the
    mixed product (`dots.mixed_mm`, differentiable)."""
    if dots.native(x2d) and head.dtype == x2d.dtype:
        return dots.mixed_mm(x2d, head)
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
    """The serving sites' FFN: the dense MLP, or the experts under the
    "dense" dispatch with no aux loss (padding-invariant, no host sync)."""
    if "moe" in p:
        h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
        y, _ = M.moe_ffn(p["moe"], h, cfg.moe, dispatch="dense",
                         return_aux=False)
        x = x + y
    elif "mlp" in p:
        h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = x + L.mlp(p["mlp"], h)
    return x


def _train_ffn(p: Params, cfg: ModelConfig, x):
    """The training and `forward_logits` FFN: the experts under the spec's
    dispatch with the aux loss (None for a dense MLP)."""
    if "moe" in p:
        h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
        y, aux = M.moe_ffn(p["moe"], h, cfg.moe)
        return x + y, aux
    return _ffn(p, cfg, x), None


def cross_entropy_sum(logits, targets):
    """(sum of the next-token losses in fp32, counted tokens) of logits
    (B, T, V) against their targets (B, T) (a target < 0 masks its
    position)."""
    logits = logits.float()
    valid = targets >= 0
    tsafe = torch.where(valid, targets, 0)
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, tsafe[..., None])[..., 0]
    nll = torch.where(valid, lse - picked, 0.0)
    return nll.sum(), valid.sum()


def _add_aux(aux, a):
    """aux + a per coordinate (lists), where None stands for no MoE layer
    yet."""
    if a is None:
        return aux
    return a if aux is None else [x + y for x, y in zip(aux, a)]


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
                   enc_out=None, plan=None):
    """Run every super-block (enc_out: the encoder's output, which "xattn"
    layers attend; with a plan, one per coordinate). With `remat` (and
    autograd recording), each super-block is a `torch.utils.checkpoint`
    region under
    REMAT_POLICIES[remat_policy]: its activations are recomputed in the
    backward pass (the JAX package's jax.checkpoint around the scan body).
    Returns (x, aux): aux is the MoE layers' aux loss summed over every
    layer of every super-block, an fp32 scalar (zero without MoE).

    plan: a mesh's training plan (`OneDevice`'s training hooks, answered by
    `distributed.train_parallel.TrainPlan`); `blocks` and `x` are then lists
    over its local coordinates, and so are the returned x and aux. The
    residual is re-laid to the plan's activation layout before the first
    super-block (`layers.with_activation_constraint`) and after each one
    (`plan.block_output`), and each super-block starts from the plan's
    block input; a remat region recomputes the plan's collectives too, in
    the same order."""
    one = plan is None
    if one:
        blocks, x, plan = [blocks], [x], ONE_DEVICE
        enc_out = [enc_out]
    policy = REMAT_POLICIES[remat_policy]

    def block_fn(xs, blks):
        xs = plan.block_input(xs)
        aux = None
        for i, kind in enumerate(cfg.layer_pattern):
            lps = [b[f"l{i}"] for b in blks]
            hs = [L.rmsnorm(p["norm1"], x, cfg.norm_eps)
                  for p, x in zip(lps, xs)]
            ws = plan.layer_mixer(lps, i)
            if _is_mamba(kind):
                ys = plan.whole(lambda hs, ws=ws: [
                    S.mamba_block(w, h, cfg.ssm, chunk=cfg.ssm.chunk_size)
                    for w, h in zip(ws, hs)], hs)
            else:
                ys = plan.attention(i, ws, plan.attn_cfg(cfg, kind, i), hs,
                                    impl)
            xs = [x + y for x, y in zip(xs, ys)]
            if kind == "xattn":
                xcfg = attn_cfg(cfg, kind, cross=True)
                xs = [x + L.attention_layer(
                    w, xcfg, L.rmsnorm(p["norm_x"], x, cfg.norm_eps),
                    kv_x=e, impl=impl)
                    for p, w, x, e in zip(lps, plan.layer_cross(lps, i), xs,
                                          enc_out)]
            xs, a = plan.train_ffn(lps, cfg, i, xs)
            aux = _add_aux(aux, a)
        return plan.block_output(xs), aux

    kw = {}
    if policy is not None:
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, policy)
    xs, aux = L.with_activation_constraint(x, plan), None
    for sb in range(len(blocks[0])):
        blks = [b[sb] for b in blocks]
        if remat and torch.is_grad_enabled():
            xs, a = ckpt.checkpoint(block_fn, xs, blks, use_reentrant=False,
                                    **kw)
        else:
            xs, a = block_fn(xs, blks)
        aux = _add_aux(aux, a)
    if aux is None:
        aux = [torch.zeros((), dtype=torch.float32, device=y.device)
               for y in xs]
    return (xs[0], aux[0]) if one else (xs, aux)


def encode(params: Params, cfg: ModelConfig, batch, *,
           impl: Optional[str] = None) -> torch.Tensor:
    """Whisper encoder over precomputed frame embeddings
    (batch["enc_embeddings"], (B, Lenc, Dm); the conv frontend is a stub):
    sinusoidal positions, the bidirectional (SWAT band, under with_swat)
    self-attention stack, final norm."""
    x = batch["enc_embeddings"].to(_dtype(cfg))
    x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model,
                                   x.device).to(x.dtype)[None]
    x, _ = _stack_forward(params["enc_blocks"], cfg_encoder(cfg), x,
                          impl=impl, remat=False)
    return L.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _forward(params: Params, cfg: ModelConfig, batch, *,
             impl: Optional[str], remat: bool, remat_policy: str,
             plan=None):
    """(final hidden states, summed MoE aux loss); with a plan, lists over
    its local coordinates (the encoder runs on each coordinate's rows)."""
    _check_supported(cfg)
    if plan is not None:
        enc_outs = (plan.encode(params, cfg, batch, impl=impl)
                    if cfg.encoder_decoder else [None] * len(params))
        xs = plan.embed(params, cfg, batch)
        return _stack_forward([p["blocks"] for p in params], cfg, xs,
                              impl=impl, remat=remat,
                              remat_policy=remat_policy, enc_out=enc_outs,
                              plan=plan)
    enc_out = (encode(params, cfg, batch, impl=impl)
               if cfg.encoder_decoder else None)
    x = embed_tokens(params, cfg, batch)
    return _stack_forward(params["blocks"], cfg, x, impl=impl, remat=remat,
                          remat_policy=remat_policy, enc_out=enc_out)


def forward_logits(params: Params, cfg: ModelConfig, batch, *,
                   impl: Optional[str] = None, remat: bool = False,
                   remat_policy: str = "nothing", plan=None):
    """Full-sequence logits (B, L, V), fp32 (MoE layers run the spec's
    dispatch, as in training). `remat` recomputes each super-block in the
    backward pass (training); serving leaves it off. plan: a mesh's
    training plan; params and batch are then lists over its local
    coordinates, and so are the logits (each coordinate's rows, every
    position)."""
    x, _ = _forward(params, cfg, batch, impl=impl, remat=remat,
                    remat_policy=remat_policy, plan=plan)
    if plan is None:
        return _unembed(params, cfg, x)
    return plan.logits(params, cfg, x)


def loss_fn(params: Params, cfg: ModelConfig, batch, *,
            impl: Optional[str] = None, remat: bool = True,
            aux_weight: float = 0.01, remat_policy: str = "nothing",
            plan=None):
    """Next-token cross entropy in fp32 plus `aux_weight` times the MoE
    layers' load-balance loss summed over layers. batch["labels"]: (B, L)
    int; positions with label < 0 are masked out. Returns (total, {"loss",
    "aux_loss", "tokens"}) as 0-dim tensors; aux_loss is zero without MoE
    layers.

    plan: a mesh's training plan (`distributed.train_parallel.TrainPlan`);
    params and batch are then lists over its local coordinates (each
    coordinate's param shards and its batch rows), and `total` is the list
    of the coordinates' objectives: their sum over the whole mesh is the
    total above, so that the gradient of that sum, through the
    collectives' transposes, is the single-device gradient. The metrics
    are the global values, on every coordinate."""
    x, aux = _forward(params, cfg, batch, impl=impl, remat=remat,
                      remat_policy=remat_policy, plan=plan)
    if plan is not None:
        return plan.objective(params, cfg, x, batch, aux, aux_weight)
    loss, denom = cross_entropy(_unembed(params, cfg, x), batch["labels"])
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux_loss": aux,
                   "tokens": denom.to(torch.float32)}


def cross_entropy(logits, labels):
    """Next-token cross entropy in fp32 of (B, L, V) logits against (B, L)
    labels (label < 0 masks a position). Returns (mean loss, counted
    tokens)."""
    total, count = cross_entropy_sum(logits[:, :-1], labels.long()[:, 1:])
    denom = torch.clamp(count, min=1)
    return total / denom, denom


# --------------------------------------------------------------- serving ---

def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                enc_len: int = 0, lookahead: int = 0, paged: bool = False,
                device="cuda", shared_pool: bool = True) -> Caches:
    """Per-super-block decode caches (zeroed rings, step 0); "xattn" layers
    also get zeroed cross K/V ("xk", "xv") of max(enc_len, 1) rows. With
    `paged`, each attention layer holds block pools and a table
    (`layers.init_paged_kv_cache`) instead of a ring; every layer
    position's `table` is ONE tensor shared by reference by all
    super-blocks (the JAX package broadcasts one table over the stacked
    axis), so a host push updates it once; `shared_pool` False gives the
    slot-local pools a mesh shards. Identity tables make a fresh
    paged cache gather-equal to a fresh contiguous one. A mamba layer holds
    `ssm.init_mamba_cache`'s zeroed conv window and SSM state in both
    layouts."""
    _check_supported(cfg)
    dt = _dtype(cfg)
    init = (functools.partial(L.init_paged_kv_cache, shared_pool=shared_pool)
            if paged else L.init_kv_cache)
    tables: Dict[int, torch.Tensor] = {}

    def layer(i, kind):
        if _is_mamba(kind):
            return S.init_mamba_cache(cfg.d_model, cfg.ssm, batch, dt, device)
        cache = init(attn_cfg(cfg, kind, index=i), batch, max_len, dtype=dt,
                     lookahead=lookahead, device=device)
        if paged:
            cache["table"] = tables.setdefault(i, cache["table"])
        if kind == "xattn":
            cache.update(_cross_cache(cfg, batch, enc_len, dt, device))
        return cache

    return [{f"l{i}": layer(i, kind)
             for i, kind in enumerate(cfg.layer_pattern)}
            for _ in range(cfg.num_super_blocks)]


def _cross_cache(cfg: ModelConfig, batch: int, enc_len: int, dt, device):
    """Zeroed cross K/V ("xk", "xv") of max(enc_len, 1) encoder rows."""
    shape = (batch, cfg.num_kv_heads, max(enc_len, 1), cfg.resolved_head_dim)
    return {"xk": torch.zeros(shape, dtype=dt, device=device),
            "xv": torch.zeros(shape, dtype=dt, device=device)}


def paged_layout(cfg: ModelConfig, max_len: int,
                 lookahead: int = 0) -> Dict[int, Dict[str, int]]:
    """Block geometry per attention-bearing layer_pattern position: the
    host-side contract between `init_caches(paged=True)` and the serving block
    allocator (`serving/paged.py`). Keys are pattern indices; values carry
    the page size, blocks per slot (nb), logical capacity, pinned-global
    count g and ring modulus."""
    out: Dict[int, Dict[str, int]] = {}
    for i, kind in enumerate(cfg.layer_pattern):
        if _is_mamba(kind):
            continue
        acfg = attn_cfg(cfg, kind, index=i)
        cap = L.cache_capacity(acfg, max_len, lookahead)
        g = acfg.spec.num_global if acfg.spec.is_sparse else 0
        out[i] = {"page": L.PAGE_SIZE,
                  "nb": L.paged_num_blocks(acfg, max_len, lookahead),
                  "cap": cap, "g": g, "ring": cap - g}
    return out


class OneDevice:
    """The compute plan of one device: one coordinate that holds every
    param and cache whole, and no collective. `decode_step`,
    `prefill_chunk` and `prefill` run each layer over lists with one entry
    per local coordinate of a plan, through these hooks; a mesh's plan
    (`distributed.tensor_parallel.MeshPlan`) answers the same ones for its
    shards, with the collectives where its tables split a weight, a cache
    or the heads."""

    def embed(self, ps, cfg: ModelConfig, batches):
        return [embed_tokens(p, cfg, b) for p, b in zip(ps, batches)]

    def encode(self, ps, cfg: ModelConfig, batches, impl=None):
        """The whisper encoder's output per coordinate (its rows)."""
        return [encode(p, cfg, b, impl=impl) for p, b in zip(ps, batches)]

    def cross_params(self, ps, sb: int, i: int):
        """Per coordinate, the cross-attention params of "xattn" layer i of
        super-block sb."""
        return [p["blocks"][sb][f"l{i}"]["cross"] for p in ps]

    def unembed(self, ps, cfg: ModelConfig, xs):
        return [_unembed(p, cfg, x) for p, x in zip(ps, xs)]

    def mixer(self, ps, sb: int, i: int):
        """Per coordinate, the mixer params of layer i of super-block sb."""
        return [p["blocks"][sb][f"l{i}"]["mixer"] for p in ps]

    def attn_cfg(self, cfg: ModelConfig, kind: str, i: int):
        """The attention layer's config at the coordinates' head counts."""
        return attn_cfg(cfg, kind, index=i)

    def split_rings(self, acfg) -> Optional[int]:
        """The decode kernel's split plan (`ops.decode_attention`)."""
        return None

    def cache_views(self, caches, sb: int, i: int):
        """(per coordinate, the decode cache of layer i of super-block sb;
        whether the caller writes the views back with `write_back`)."""
        return [c[sb][f"l{i}"] for c in caches], False

    def write_back(self, caches, sb: int, i: int, views) -> None:
        pass

    def attn_out(self, i: int, ys):
        """The attention outputs' reduction over the heads' shards."""
        return ys

    def ffn(self, ps, cfg: ModelConfig, sb: int, i: int, xs):
        return [_ffn(p["blocks"][sb][f"l{i}"], cfg, x) for p, x in zip(ps, xs)]

    # training hooks (`_stack_forward`): lps are the coordinates' params of
    # one layer of one super-block
    def block_input(self, xs):
        """A super-block's input from the boundary layout."""
        return xs

    def constrain(self, xs):
        """The residual re-laid to the activation layout at a super-block
        boundary (`layers.with_activation_constraint`)."""
        return xs

    def block_output(self, xs):
        """A super-block's output re-laid to the activation layout."""
        return self.constrain(xs)

    def layer_mixer(self, lps, i: int):
        return [p["mixer"] for p in lps]

    def layer_cross(self, lps, i: int):
        return [p["cross"] for p in lps]

    def attention(self, i: int, ws, acfg, hs, impl):
        """A full-sequence attention layer's outputs per coordinate."""
        return self.attn_out(i, [L.attention_layer(w, acfg, h, impl=impl)
                                 for w, h in zip(ws, hs)])

    def whole(self, fn, hs):
        """fn over the coordinates' whole sequences (a plan that splits
        the sequence gathers it first and keeps each coordinate's block of
        the result)."""
        return fn(hs)

    def train_ffn(self, lps, cfg: ModelConfig, i: int, xs):
        """(the FFN's outputs, its aux losses or None) per coordinate."""
        out = [_train_ffn(p, cfg, x) for p, x in zip(lps, xs)]
        auxes = [a for _, a in out]
        return ([y for y, _ in out],
                None if auxes[0] is None else auxes)


ONE_DEVICE = OneDevice()


def _coords(params, batch, caches, plan):
    """(params, batches, caches, plan) as lists over the plan's local
    coordinates: with no plan, one device's, each a list of one."""
    if plan is None:
        return [params], [batch], [caches], ONE_DEVICE
    return params, batch, caches, plan


@torch.no_grad()
def decode_step(params: Params, cfg: ModelConfig, batch, caches: Caches, *,
                impl: Optional[str] = None, lookahead: int = 0, plan=None):
    """T tokens for every sequence (usually T=1). batch: {"tokens": (B, T)}
    (or {"embeddings": (B, T, Dm)}). Per-slot cache steps: rows may sit at
    different positions. T > 1 needs caches allocated with lookahead >=
    T-1; a config with a mamba layer decodes T=1 only. "xattn" layers
    attend the cross K/V that prefill stored. Caches update IN PLACE, steps
    and mamba states included: every cache tensor keeps its storage. Runs
    without autograd.

    With the decode kernel as the attention impl (`impl` "kernel", or None
    on CUDA tensors) and an attention layer in the config, an armed
    injected dispatch failure (`swat_decode.set_force_fail`) raises here,
    before any layer writes its cache: in a hybrid stack mamba layers run
    before the first attention layer, and the step must fail as a whole,
    as the JAX engine's does at trace time. Returns (logits (B, T, V)
    fp32, caches).

    plan: a mesh's compute plan (`OneDevice`'s hooks); params, batch and
    caches are then lists with one entry per local coordinate, and so are
    the logits returned."""
    _check_supported(cfg)
    one = plan is None
    ps, bs, cs, plan = _coords(params, batch, caches, plan)
    xs = plan.embed(ps, cfg, bs)
    t = xs[0].shape[1]
    attn = [i for i, k in enumerate(cfg.layer_pattern) if not _is_mamba(k)]
    if t > 1 and len(attn) < len(cfg.layer_pattern):
        raise ValueError(f"{cfg.name}: a {t}-token decode step; mamba layers "
                         "update their state one token at a time")
    if attn and (impl or kops.default_impl(xs[0])) == "kernel":
        swat_decode.check_force_fail()
    # every attention layer's cache advances together, so the rope tables
    # at step + arange(T) and the per-slot row count are the same for all
    # layers: build them once per step (each is several launches) from the
    # first attention layer's cache; so is the encoder length, built at the
    # first cross layer from its (gathered) cross K/V
    ropes, nums = [], []
    encs = [None] * len(xs)
    for x, c in zip(xs, cs):
        first = c[0][f"l{attn[0]}"] if attn else {}
        rope = None
        if cfg.use_rope and attn:
            step = first["step"]
            pos = (step.long()[:, None, None]
                   + torch.arange(t, device=step.device))
            rope = L.rope_tables(pos, cfg.resolved_head_dim, cfg.rope_theta)
        b = x.shape[0]
        ropes.append(rope)
        nums.append(torch.full((b,), t, dtype=torch.int32, device=x.device))
    for sb in range(len(ps[0]["blocks"])):
        for i, kind in enumerate(cfg.layer_pattern):
            lps = [p["blocks"][sb][f"l{i}"] for p in ps]
            hs = [L.rmsnorm(p["norm1"], x, cfg.norm_eps)
                  for p, x in zip(lps, xs)]
            ws = plan.mixer(ps, sb, i)
            views, gathered = plan.cache_views(cs, sb, i)
            if _is_mamba(kind):
                ys = [S.mamba_decode(w, h, v, cfg.ssm)[0]
                      for w, h, v in zip(ws, hs, views)]
            else:
                acfg = plan.attn_cfg(cfg, kind, i)
                ys = plan.attn_out(i, [
                    L.attention_decode(w, acfg, h, v, impl=impl,
                                       lookahead=lookahead, rope=r,
                                       num_new=n, step_in_place=True,
                                       split_rings=plan.split_rings(acfg))[0]
                    for w, h, v, r, n in zip(ws, hs, views, ropes, nums)])
            if gathered:
                plan.write_back(cs, sb, i, views)
            xs = [x + y for x, y in zip(xs, ys)]
            if kind == "xattn":
                xcfg = attn_cfg(cfg, kind, cross=True)
                for k, (p, w, x) in enumerate(zip(
                        lps, plan.cross_params(ps, sb, i), xs)):
                    if encs[k] is None:
                        encs[k] = torch.full(
                            (x.shape[0],), views[k]["xk"].shape[2],
                            dtype=torch.int32, device=x.device)
                    h = L.rmsnorm(p["norm_x"], x, cfg.norm_eps)
                    xs[k] = x + L.cross_attention_decode(
                        w, xcfg, h, views[k], encs[k], impl=impl)
            xs = plan.ffn(ps, cfg, sb, i, xs)
    logits = plan.unembed(ps, cfg, xs)
    return (logits[0] if one else logits), caches


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
                  lookahead: int = 0, plan=None) -> torch.Tensor:
    """One lockstep chunk of a batched chunked prefill: tokens [pos0,
    pos0+T) of every row through the stack against the ring caches, which
    take the chunk's K/V IN PLACE. Equal to single-shot `prefill` on the
    band, with per-layer scores of O(T * (cap + T)). lengths: (B,) real
    prompt lengths. Returns the hidden states (B, T, Dm): unembedding is
    the caller's, which gathers the one last-real-token row per sequence
    first. Runs without autograd. plan: as `decode_step`'s (lengths is
    then a list too; a mesh plan's caches are its plan-local chunk
    caches)."""
    if not prefill_chunkable(cfg):
        raise ValueError(f"{cfg.name}: prefill chunks need rotary "
                         f"attention-only layers, not {cfg.layer_pattern}")
    _check_supported(cfg)
    one = plan is None
    ps, bs, cs, plan = _coords(params, batch, caches, plan)
    lens = [lengths] if one else lengths
    xs = plan.embed(ps, cfg, bs)
    t = xs[0].shape[1]
    # every layer shares the chunk's positions: one set of rope tables
    pos = pos0 + torch.arange(t, device=xs[0].device)
    rope = L.rope_tables(pos, cfg.resolved_head_dim, cfg.rope_theta)
    for sb in range(len(ps[0]["blocks"])):
        for i, kind in enumerate(cfg.layer_pattern):
            hs = [L.rmsnorm(p["blocks"][sb][f"l{i}"]["norm1"], x,
                            cfg.norm_eps) for p, x in zip(ps, xs)]
            acfg = plan.attn_cfg(cfg, kind, i)
            ys = plan.attn_out(i, [
                L.attention_prefill_chunk(w, acfg, h, c[sb][f"l{i}"], pos0,
                                          n, impl=impl, lookahead=lookahead,
                                          rope=rope)[0]
                for w, h, c, n in zip(plan.mixer(ps, sb, i), hs, cs, lens)])
            xs = plan.ffn(ps, cfg, sb, i, [x + y for x, y in zip(xs, ys)])
    return xs[0] if one else xs


@torch.no_grad()
def prefill(params: Params, cfg: ModelConfig, batch, max_len: int, *,
            impl: Optional[str] = None, lengths=None, lookahead: int = 0,
            plan=None):
    """Run the prompt, return (last-position logits (B, 1, V), primed
    caches). lengths: optional (B,) real prompt lengths of a right-padded
    batch — per-row cache steps, and logits gathered at each row's last
    real token. Causality makes the pad tail inert. Encoder-decoder
    configs run the encoder over batch["enc_embeddings"] first, and each
    "xattn" layer stores the encoder's cross K/V in its cache ("xk",
    "xv"); they take no `lengths`, as in the JAX package. A mamba layer
    keeps its final conv window and SSM state (`_mamba_prefill_cache`).
    Runs without autograd. plan: as `decode_step`'s (lengths is then a
    list too; a mesh plan's caches come back in its plan-local layout)."""
    _check_supported(cfg)
    one = plan is None
    ps, bs, _, plan = _coords(params, batch, None, plan)
    lens = ([lengths] if one else
            [None] * len(ps) if lengths is None else lengths)
    if cfg.encoder_decoder and any(n is not None for n in lens):
        raise ValueError("padded prefill: decoder-only models")
    enc_outs = (plan.encode(ps, cfg, bs, impl=impl)
                if cfg.encoder_decoder else None)
    xs = plan.embed(ps, cfg, bs)
    caches: List[Caches] = [[] for _ in xs]
    for sb in range(len(ps[0]["blocks"])):
        new = [{} for _ in xs]
        for i, kind in enumerate(cfg.layer_pattern):
            lps = [p["blocks"][sb][f"l{i}"] for p in ps]
            hs = [L.rmsnorm(p["norm1"], x, cfg.norm_eps)
                  for p, x in zip(lps, xs)]
            ys = []
            if _is_mamba(kind):
                for k, (w, h, n) in enumerate(zip(plan.mixer(ps, sb, i), hs,
                                                  lens)):
                    m = S.mamba_inputs(w, h, cfg.ssm)
                    ys.append(S.mamba_block(w, h, cfg.ssm,
                                            chunk=cfg.ssm.chunk_size,
                                            inputs=m))
                    new[k][f"l{i}"] = _mamba_prefill_cache(
                        w, h, cfg, lengths=n, inputs=m)
            else:
                acfg = plan.attn_cfg(cfg, kind, i)
                for k, (w, h, n) in enumerate(zip(plan.mixer(ps, sb, i), hs,
                                                  lens)):
                    y, kk, vv = L.attention_layer(w, acfg, h, impl=impl,
                                                  return_kv=True)
                    ys.append(y)
                    new[k][f"l{i}"] = L.prefill_kv_cache(
                        acfg, kk, vv, max_len, lengths=n,
                        lookahead=lookahead)
                ys = plan.attn_out(i, ys)
            xs = [x + y for x, y in zip(xs, ys)]
            if kind == "xattn":
                xcfg = attn_cfg(cfg, kind, cross=True)
                for k, (p, w, x) in enumerate(zip(
                        lps, plan.cross_params(ps, sb, i), xs)):
                    cache = new[k][f"l{i}"]
                    h = L.rmsnorm(p["norm_x"], x, cfg.norm_eps)
                    y, cache["xk"], cache["xv"] = L.attention_layer(
                        w, xcfg, h, kv_x=enc_outs[k], impl=impl,
                        return_kv=True)
                    xs[k] = x + y
            xs = plan.ffn(ps, cfg, sb, i, xs)
        for c, n in zip(caches, new):
            c.append(n)
    lasts = []
    for x, n in zip(xs, lens):
        if n is None:
            lasts.append(x[:, -1:])
            continue
        b, l, _ = x.shape
        idx = torch.clamp(n.to(x.device).long() - 1, 0, l - 1)
        lasts.append(x[torch.arange(b, device=x.device), idx][:, None])
    logits = plan.unembed(ps, cfg, lasts)
    return (logits[0], caches[0]) if one else (logits, caches)


def _mamba_prefill_cache(p: Params, h, cfg: ModelConfig, lengths=None,
                         inputs=None) -> Dict[str, torch.Tensor]:
    """Final conv window and SSM state after a full-sequence mamba pass over
    the normed input h (B, L, Dm); `inputs`: h's `ssm.mamba_inputs`, when
    the caller has them. With `lengths`, each row's state stops at its own
    last real token: a zeroed dt beyond the length makes the decay exp(0)
    = 1 and the update 0, so the state freezes, and the conv window is
    gathered per row, zero-filled where it precedes t = 0. The state is
    one fp32 pass: sum_j exp(sum_{k>j} dt_k a) dt_j B_j x_j."""
    spec = cfg.ssm
    m = S.mamba_inputs(p, h, spec) if inputs is None else inputs
    conv_in = m["conv_in"]
    bsz, l, _ = h.shape
    kw = spec.conv_width
    if lengths is None:
        conv_state = conv_in[:, -(kw - 1):, :]
        if l < kw - 1:
            conv_state = torch.nn.functional.pad(
                conv_in, (0, 0, kw - 1 - l, 0))
    else:
        lens = lengths.to(h.device).long()
        idx = lens[:, None] - (kw - 1) + torch.arange(kw - 1,
                                                      device=h.device)
        gathered = conv_in.gather(1, idx.clamp(min=0)[:, :, None].expand(
            bsz, kw - 1, conv_in.shape[-1]))
        conv_state = gathered.masked_fill((idx < 0)[:, :, None], 0)
    nh = spec.num_heads(cfg.d_model)
    dtv = m["dt"]
    if lengths is not None:
        tmask = (torch.arange(l, device=h.device)[None, :]
                 < lengths.to(h.device)[:, None])
        dtv = dtv * tmask[..., None]
    a = -torch.exp(p["a_log"])
    cum = torch.cumsum(dtv * a, dim=1)
    w = torch.exp(cum[:, -1:, :] - cum)                      # (B,L,H)
    bm = m["b"].repeat_interleave(nh // spec.num_groups, dim=2)
    ssm = torch.einsum("blh,blhs,blhp->bhps", w * dtv, bm.float(),
                       m["xh"].float())
    return {"conv": conv_state.to(_dtype(cfg)), "ssm": ssm}
