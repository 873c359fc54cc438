"""Core configuration dataclasses shared by every layer of the framework.

Host-side copy of the JAX package's `core/types.py`. Everything here is
frozen and hashable, so configs can key caches (block patterns, uploaded
pattern tensors).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    """Static sparse attention pattern (the paper's design-time parameters).

    kind:
      dense           - vanilla softmax attention (the paper's GPU baseline)
      swat            - exact-band window attention (the paper's contribution)
      sliding_chunks  - HuggingFace Longformer chunked baseline (~50% redundant)
    window          - w. each token attends [i-w, i+w] (bidirectional) or
                      [i-w, i] (causal). 0 means no band restriction.
    num_global      - first g tokens are global (attend all / attended by all),
                      Longformer-style.
    num_random      - random *blocks* each q-block additionally attends
                      (BigBird-style, static at trace time from random_seed).
    causal          - decoder-style masking.
    softcap         - gemma2-style logit soft capping (0 = off).
    """

    kind: str = "dense"
    window: int = 0
    num_global: int = 0
    num_random: int = 0
    random_seed: int = 0
    causal: bool = True
    softcap: float = 0.0

    def __post_init__(self):
        assert self.kind in ("dense", "swat", "sliding_chunks"), self.kind
        if self.kind != "dense":
            assert self.window > 0, "sparse attention needs a window"

    @property
    def is_sparse(self) -> bool:
        return self.kind != "dense"

    def flops_per_row(self, seq_len: int, head_dim: int) -> float:
        """Attention matmul FLOPs for one query row (one head), for
        benchmarks/fig1. 2*D per score + 2*D per value-accumulate."""
        if self.kind == "dense":
            cols = seq_len
        elif self.kind == "swat":
            cols = min(seq_len, (self.window + 1) if self.causal
                       else (2 * self.window + 1))
            cols += min(self.num_global, seq_len)
        else:  # sliding_chunks: dense 2w x 2w chunks with 50% redundancy
            cols = min(seq_len, 2 * self.window) * 2
        return 4.0 * cols * head_dim


@dataclasses.dataclass(frozen=True)
class MoESpec:
    """dispatch:
      sort  - capacity + sort/scatter dispatch, EP all-to-all (the classic
              big-E MoE schedule; right when k/E is small).
      dense - tokens stationary, every expert computed locally, combined by
              the (renormalized) top-k gates. Costs E/k x active FFN FLOPs
              but ZERO dispatch collectives and no capacity drops — strictly
              better when E/k is small and the cell is collective-bound
              (granite-moe: E/k = 4; see EXPERIMENTS.md §Perf cell 1).
      ep    - explicit expert parallelism: shard_map token exchange with two
              all-to-alls over 'model' (core/moe_ep.py). Wire bytes scale
              with LOCAL tokens only; the schedule production MoE systems
              use. Right when E/k is large (moonshot 64/6, jamba 16/2).
    """
    num_experts: int = 0
    top_k: int = 0
    dispatch: str = "sort"

    def __post_init__(self):
        assert self.dispatch in ("sort", "dense", "ep"), self.dispatch

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    """Mamba2 SSD hyper-parameters."""
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256
    num_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture. layer_pattern describes the repeating super-block;
    num_layers must be divisible by its length (scan-over-layers operates on
    super-blocks so heterogeneous stacks stay scannable).

    layer entries: "attn" (+dense ffn), "attn_moe", "mamba", "mamba_moe",
    "local_attn", "global_attn" (gemma2 alternation).
    """

    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                      # 0 -> d_model // num_heads
    layer_pattern: Tuple[str, ...] = ("attn",)
    attention: AttentionSpec = AttentionSpec()
    local_attention: Optional[AttentionSpec] = None   # for "local_attn" layers
    # Per-layer window schedule, one entry per layer_pattern position (the
    # SWAA / gemma2 mixed local-global regime). None entries inherit the
    # layer kind's spec unchanged; an int w overrides that position's
    # attention to a causal w-window (sparse specs keep their
    # num_global/softcap, dense specs become plain swat windows). Cache
    # shapes follow: each position allocates its own ring capacity.
    window_schedule: Optional[Tuple[Optional[int], ...]] = None
    moe: MoESpec = MoESpec()
    ssm: SSMSpec = SSMSpec()
    qkv_bias: bool = False                 # qwen2.5
    tie_embeddings: bool = False
    embed_scale: bool = False              # gemma2: x *= sqrt(d_model)
    use_rope: bool = True                  # whisper: sinusoidal instead
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    final_softcap: float = 0.0             # gemma2 final-logit capping
    embed_inputs: bool = True              # False -> frontend stub feeds embeddings
    frontend: str = "none"                 # none | vision | audio (stub type)
    encoder_decoder: bool = False          # whisper
    encoder_layers: int = 0
    max_decode_len: int = 0                # structural decoder limit (whisper: 448)
    dtype: str = "bfloat16"

    def __post_init__(self):
        assert self.num_layers % len(self.layer_pattern) == 0, (
            f"{self.name}: {self.num_layers} layers not divisible by "
            f"pattern {self.layer_pattern}")
        if self.num_heads:
            assert self.num_heads % max(self.num_kv_heads, 1) == 0
        if self.window_schedule is not None:
            assert len(self.window_schedule) == len(self.layer_pattern), (
                f"{self.name}: window_schedule length "
                f"{len(self.window_schedule)} != layer_pattern length "
                f"{len(self.layer_pattern)}")
            assert all(w is None or w > 0 for w in self.window_schedule), \
                "window_schedule entries must be None or a positive window"

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads

    @property
    def num_super_blocks(self) -> int:
        return self.num_layers // len(self.layer_pattern)

    @property
    def is_attention_free(self) -> bool:
        return all(k.startswith("mamba") for k in self.layer_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True when prefill cost is o(N^2): SSM/hybrid or windowed attention
        on every attention layer."""
        for i, kind in enumerate(self.layer_pattern):
            if kind.startswith("mamba"):
                continue
            if (self.window_schedule is not None
                    and self.window_schedule[i] is not None):
                continue  # scheduled to a finite window at this position
            spec = (self.local_attention if kind == "local_attn"
                    else self.attention)
            if spec is None or not spec.is_sparse:
                return False
        return True


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (assignment: 4 per arch)."""
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"

    def __post_init__(self):
        assert self.mode in ("train", "prefill", "decode")


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
