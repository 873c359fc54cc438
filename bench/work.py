"""The benchmark's own count of useful work, and the H100's peaks.

A frozen yardstick: every roofline share and `mfu.*` metric divides the
least time computed here by a measured time. The counts come from a
configuration's file (`bench/configs/<name>.json`) and the traffic the
benchmark itself sent, never from the program's counters, so a kernel's
share reads the same work whatever implements it.

What counts as work (each input read once, each output written once):
- attention counts only the columns a query may see: the window's, the
  pinned globals' and, in decode, the ring rows that are live;
- an MoE layer counts its top-k experts only, and the router;
- training counts the forward and the backward (2x the forward) and no
  recomputation; the attention backward counts its four gradient
  products (2x the forward's two) and not the recomputed scores;
- padding rows of a batched prefill are not work.

Least time of a call or step: the larger of FLOPs over the bf16 peak and
bytes over HBM bandwidth.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM5 data sheet, dense rates without sparsity, at 700 W
PEAKS = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12,
         "hbm_bytes": 80e9}
BF16, FP32 = 2, 4


def least_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAKS["bf16_flops"], nbytes / PEAKS["hbm_bytes_per_s"])


@dataclasses.dataclass(frozen=True)
class Shape:
    layers: int
    d: int
    hq: int
    hkv: int
    hd: int
    d_ff: int
    vocab: int
    experts: int
    top_k: int
    window: int
    globals_: int

    @classmethod
    def from_config(cls, c: dict) -> "Shape":
        return cls(layers=c["num_hidden_layers"], d=c["hidden_size"],
                   hq=c["num_attention_heads"],
                   hkv=c["num_key_value_heads"], hd=c["head_dim"],
                   d_ff=c["intermediate_size"], vocab=c["vocab_size"],
                   experts=c["num_local_experts"],
                   top_k=c["num_experts_per_tok"],
                   window=c["swat"]["window"],
                   globals_=c["swat"]["num_global"])

    # ------------------------------------------------------- parameters
    @property
    def attn_params(self) -> int:
        return self.d * (self.hq + 2 * self.hkv) * self.hd \
            + self.hq * self.hd * self.d

    @property
    def ffn_active_params(self) -> int:
        """Parameters one token multiplies in a layer's FFN: the dense MLP,
        or the top-k experts and the router."""
        if self.experts:
            return self.top_k * 3 * self.d * self.d_ff + self.d * self.experts
        return 3 * self.d * self.d_ff

    @property
    def ffn_params(self) -> int:
        if self.experts:
            return self.experts * 3 * self.d * self.d_ff
        return 3 * self.d * self.d_ff

    @property
    def params(self) -> int:
        norms = (2 * self.layers + 1) * self.d
        router = self.layers * self.d * self.experts
        return (self.layers * (self.attn_params + self.ffn_params)
                + self.vocab * self.d + norms + router)

    @property
    def weight_bytes(self) -> int:
        """The served weights: bf16 matrices, fp32 norms and router."""
        fp32 = (2 * self.layers + 1) * self.d \
            + self.layers * self.d * self.experts
        return BF16 * (self.params - fp32) + FP32 * fp32

    @property
    def ring_cap(self) -> int:
        """Live rows of a full ring: the window, the token itself and the
        globals."""
        return self.window + 1 + self.globals_

    # ------------------------------------------------------- attention
    def cols(self, n: int) -> int:
        """Columns the first n queries of a causal sequence see in total:
        query i sees j <= i with j >= i - window, or j < globals."""
        w, g = self.window, self.globals_
        if n <= w + 1:
            band = n * (n + 1) // 2
        else:
            band = (w + 1) * (w + 2) // 2 + (n - w - 1) * (w + 1)
        m = max(0, n - 1 - w)          # queries past the window's reach
        extra = m * (m + 1) // 2 if m <= g else g * (g + 1) // 2 + (m - g) * g
        return band + extra

    def attn_flops(self, cols: int) -> float:
        """Forward attention FLOPs of one layer over `cols` (query, key)
        pairs: q.k and p.v, 2 * head_dim each, every q head."""
        return 4.0 * self.hq * self.hd * cols

    # ----------------------------------------------------------- decode
    def decode_step(self, rows) -> dict:
        """One decode step of len(rows) slots, slot s seeing rows[s] live
        ring rows (its new token included)."""
        b, live = len(rows), sum(rows)
        flops = b * 2.0 * (self.layers * (self.attn_params
                                          + self.ffn_active_params)
                           + self.vocab * self.d) \
            + self.layers * self.attn_flops(live)
        kv_row = 2 * self.hkv * self.hd * BF16
        nbytes = self.weight_bytes + self.layers * kv_row * live \
            + b * self.vocab * FP32
        return {"flops": flops, "bytes": nbytes,
                "least_s": least_s(flops, nbytes),
                "least_s.swat_decode": self.layers * self.decode_call(
                    rows)["least_s"]}

    def decode_call(self, rows) -> dict:
        """Kernel #1 on one layer: read each slot's live K/V rows and its
        q, write its new K/V row and its output."""
        b, live = len(rows), sum(rows)
        flops = self.attn_flops(live)
        nbytes = (2 * self.hkv * self.hd * live
                  + 2 * b * self.hq * self.hd + 2 * b * self.hkv * self.hd) \
            * BF16
        return {"flops": flops, "bytes": nbytes,
                "least_s": least_s(flops, nbytes)}

    # ---------------------------------------------------------- prefill
    def prefill(self, lengths) -> dict:
        """One batched prefill of prompts of the given real lengths: every
        real token through every layer, the head at each prompt's last
        token, the weights read once, each prompt's ring written."""
        tokens = sum(lengths)
        cols = sum(self.cols(n) for n in lengths)
        flops = 2.0 * self.layers * (self.attn_params
                                     + self.ffn_active_params) * tokens \
            + self.layers * self.attn_flops(cols) \
            + 2.0 * self.d * self.vocab * len(lengths)
        kv_row = 2 * self.hkv * self.hd * BF16
        nbytes = self.weight_bytes + self.layers * kv_row * sum(
            min(n, self.ring_cap) for n in lengths) \
            + len(lengths) * self.vocab * FP32
        return {"flops": flops, "bytes": nbytes,
                "least_s": least_s(flops, nbytes),
                "least_s.swat_fwd": self.layers * self.fwd_call(
                    lengths)["least_s"]}

    def fwd_call(self, lengths) -> dict:
        """Kernel #2 on one layer: q, k, v read and the output written for
        the real tokens, the columns each query sees."""
        tokens = sum(lengths)
        cols = sum(self.cols(n) for n in lengths)
        nbytes = tokens * (2 * self.hq + 2 * self.hkv) * self.hd * BF16
        flops = self.attn_flops(cols)
        return {"flops": flops, "bytes": nbytes,
                "least_s": least_s(flops, nbytes)}

    def bwd_call(self, lengths) -> dict:
        """Kernels #4 and #5 (with the combine) on one layer: read q, k, v,
        the output, its gradient and the LSE; write dq, dk, dv; the four
        gradient products (2x the forward's FLOPs)."""
        tokens = sum(lengths)
        cols = sum(self.cols(n) for n in lengths)
        nbytes = tokens * ((3 * self.hq + 2 * self.hkv) * self.hd * BF16
                           + self.hq * FP32
                           + (self.hq + 2 * self.hkv) * self.hd * BF16)
        flops = 2.0 * self.attn_flops(cols)
        return {"flops": flops, "bytes": nbytes,
                "least_s": least_s(flops, nbytes)}

    # ------------------------------------------------------------ train
    def train_forward_flops(self, lengths) -> float:
        tokens = sum(lengths)
        cols = sum(self.cols(n) for n in lengths)
        return 2.0 * (self.layers * (self.attn_params
                                     + self.ffn_active_params)
                      + self.d * self.vocab) * tokens \
            + self.layers * self.attn_flops(cols)

    def train_step(self, lengths) -> dict:
        """One AdamW step on rows of the given lengths: forward and
        backward (3x the forward), the params read and written in bf16,
        both fp32 moments read and written."""
        flops = 3.0 * self.train_forward_flops(lengths)
        nbytes = self.params * 2 * (BF16 + 2 * FP32)
        return {"flops": flops, "bytes": nbytes,
                "least_s": least_s(flops, nbytes),
                "least_s.swat_fwd": self.layers * self.fwd_call(
                    lengths)["least_s"],
                "least_s.swat_bwd": self.layers * self.bwd_call(
                    lengths)["least_s"]}
