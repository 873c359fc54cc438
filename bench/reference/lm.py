"""The plain reference of the benchmark's models: a decoder LM with SWAT
window attention (a causal window plus pinned global tokens), a dense
SwiGLU MLP or a top-k MoE with the capacity dispatch, written from the
configuration file in plain PyTorch and computed in float32 with TF32 off.

It imports nothing of the program. It reads the benchmark's weights (the
port's params layout: a dict of leaves) and the benchmark's inputs, and
works out everything else itself: positions, masks, routing, capacity,
the loss and the AdamW update.

`prec="fp8"` is the control: every matrix product's operands are rounded
to float8 e4m3 (per-tensor scale), the nearest precision below the
configuration's bf16. Under autograd the rounding passes the gradient
straight through, so the backward's products read the rounded operands.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

F8_MAX = 448.0


def exact_fp32() -> None:
    """fp32 products in fp32: no TF32 (the card's default for cuBLAS is
    already off; cuDNN's is on)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def q8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 at a per-tensor scale, back in x's dtype;
    the gradient passes through unchanged."""
    if x.numel() == 0:
        return x
    scale = x.detach().abs().amax().clamp(min=1e-30) / F8_MAX
    r = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (r - x).detach() if x.requires_grad else r


@dataclasses.dataclass(frozen=True)
class Model:
    layers: int
    d: int
    hq: int
    hkv: int
    hd: int
    vocab: int
    experts: int
    top_k: int
    window: int
    globals_: int
    eps: float
    theta: float
    embed_mult: float
    attn_scale: float
    resid_mult: float
    logits_div: float
    capacity_factor: float
    aux_weight: float
    prec: str = "fp32"

    @classmethod
    def from_config(cls, c: dict, prec: str = "fp32") -> "Model":
        moe = c.get("moe", {})
        return cls(layers=c["num_hidden_layers"], d=c["hidden_size"],
                   hq=c["num_attention_heads"],
                   hkv=c["num_key_value_heads"], hd=c["head_dim"],
                   vocab=c["vocab_size"], experts=c["num_local_experts"],
                   top_k=c["num_experts_per_tok"],
                   window=c["swat"]["window"],
                   globals_=c["swat"]["num_global"], eps=c["rms_norm_eps"],
                   theta=c["rope_theta"],
                   embed_mult=c.get("embedding_multiplier", 1.0),
                   attn_scale=c.get("attention_multiplier",
                                    c["head_dim"] ** -0.5),
                   resid_mult=c.get("residual_multiplier", 1.0),
                   logits_div=c.get("logits_scaling", 1.0),
                   capacity_factor=moe.get("capacity_factor", 1.25),
                   aux_weight=moe.get("aux_weight", 0.0), prec=prec)

    # ------------------------------------------------------------ pieces
    def mm(self, x, w):
        if self.prec == "fp8":
            x, w = q8(x), q8(w)
        return x @ w

    def norm(self, x, scale):
        x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps)
        return x * (1.0 + scale)

    def rope(self, x, pos):
        """Split-half rotary embedding of x (..., L, hd) at positions (L,)."""
        half = self.hd // 2
        freqs = self.theta ** (-torch.arange(0, self.hd, 2,
                                             device=x.device,
                                             dtype=torch.float64) / self.hd)
        ang = (pos.double()[:, None] * freqs).float()
        cos, sin = torch.cos(ang), torch.sin(ang)
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def attention(self, q, k, v, block: int = 512):
        """Causal window attention of q (B, Hq, L, hd) over k, v (B, Hkv,
        L, hd): query i sees key j <= i with j >= i - window, or j <
        globals. Computed a block of queries at a time over the keys it
        can see."""
        b, _, n, _ = q.shape
        g = self.hq // self.hkv
        k = k.repeat_interleave(g, 1)
        v = v.repeat_interleave(g, 1)
        outs = []
        for a in range(0, n, block):
            e = min(n, a + block)
            lo = max(0, a - self.window)
            gl = min(self.globals_, lo)
            cols = torch.cat([torch.arange(gl, device=q.device),
                              torch.arange(lo, e, device=q.device)])
            outs.append(ckpt.checkpoint(
                self._attend, q[:, :, a:e], k[:, :, cols], v[:, :, cols],
                cols, a, use_reentrant=False)
                if torch.is_grad_enabled() else
                self._attend(q[:, :, a:e], k[:, :, cols], v[:, :, cols],
                             cols, a))
        return torch.cat(outs, 2)

    def _attend(self, q, k, v, cols, a):
        i = torch.arange(a, a + q.shape[2], device=q.device)[:, None]
        j = cols[None, :]
        ok = (j <= i) & ((j >= i - self.window) | (j < self.globals_)
                         | (i < self.globals_))
        s = self.mm(q, k.transpose(-1, -2)) * self.attn_scale
        s = s.masked_fill(~ok, float("-inf"))
        return self.mm(torch.softmax(s, -1), v)

    def attn_block(self, x, p, pos):
        b, n, _ = x.shape
        h = self.norm(x, p["norm1"]["scale"])
        m = p["mixer"]
        q = self.mm(h, m["wq"]).view(b, n, self.hq, self.hd).transpose(1, 2)
        k = self.mm(h, m["wk"]).view(b, n, self.hkv, self.hd).transpose(1, 2)
        v = self.mm(h, m["wv"]).view(b, n, self.hkv, self.hd).transpose(1, 2)
        o = self.attention(self.rope(q, pos), self.rope(k, pos), v)
        o = o.transpose(1, 2).reshape(b, n, self.hq * self.hd)
        return x + self.resid_mult * self.mm(o, m["wo"])

    def ffn_block(self, x, p):
        """(x + FFN(norm(x)), the MoE aux loss or None)."""
        h = self.norm(x, p["norm2"]["scale"])
        if "mlp" in p:
            w = p["mlp"]
            y = self.mm(F.silu(self.mm(h, w["w1"])) * self.mm(h, w["w3"]),
                        w["w2"])
            return x + self.resid_mult * y, None
        y, aux = self.moe(h.reshape(-1, self.d), p["moe"])
        return x + self.resid_mult * y.view_as(x), aux

    def moe(self, h, w):
        """Top-k routing (fp32 softmax, ties to the lower expert), gates
        renormalised over the k; routed slots taken in token order and
        dropped past each expert's capacity round(T k cf / E), clamped to
        [k, T]; each kept slot's SwiGLU output added with its gate. Returns
        (out (T, d), Switch aux loss E * sum_e f_e P_e)."""
        t, e, k = h.shape[0], self.experts, self.top_k
        probs = torch.softmax(h @ w["router"], -1)
        vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates = vals[:, :k] / vals[:, :k].sum(-1, keepdim=True)
        ids = ids[:, :k].reshape(-1)
        counts = torch.bincount(ids, minlength=e)
        aux = e * torch.sum(counts.float() / (t * k) * probs.mean(0))
        cap = int(max(k, min(t, round(t * k * self.capacity_factor / e))))
        order = torch.argsort(ids, stable=True)
        first = torch.cumsum(counts, 0) - counts
        rank = torch.empty_like(ids)
        rank[order] = torch.arange(t * k, device=h.device) - first[ids[order]]
        keep = rank < cap
        out = torch.zeros_like(h)
        gflat = gates.reshape(-1)
        for x in range(e):
            slots = torch.nonzero((ids == x) & keep)[:, 0]
            tok = slots // k
            hx = h[tok]
            y = self.mm(F.silu(self.mm(hx, w["w1"][x]))
                        * self.mm(hx, w["w3"][x]), w["w2"][x])
            out = out.index_add(0, tok, y * gflat[slots, None])
        return out, aux

    def embed(self, table, tokens):
        return F.embedding(tokens.long(), table) * self.embed_mult

    def logits(self, x, final, table):
        return self.mm(self.norm(x, final), table.t()) / self.logits_div


def fp32_layer(p) -> Dict:
    """A layer's leaves as fp32 copies."""
    if isinstance(p, dict):
        return {k: fp32_layer(v) for k, v in p.items()}
    return p.float()


# --------------------------------------------------------------- serving
@torch.no_grad()
def served_logits(model: Model, weights: Dict, seqs: List[torch.Tensor],
                  firsts: List[int]) -> List[torch.Tensor]:
    """For each sequence (prompt + served tokens, int64 on the device),
    the logits (fp32) at positions firsts[r] - 1 onward: the rows that
    predict each served token. Layer by layer over every sequence, each
    layer's weights made fp32 once."""
    xs = [model.embed(weights["embed"].float(), s)[None] for s in seqs]
    poss = [torch.arange(s.shape[0], device=s.device) for s in seqs]
    for p in weights["blocks"]:
        lp = fp32_layer(p["l0"])
        for r, x in enumerate(xs):
            x = model.attn_block(x, lp, poss[r])
            xs[r], _ = model.ffn_block(x, lp)
        del lp
    table = weights["embed"].float()
    final = weights["final_norm"]["scale"].float()
    return [model.logits(x[0, f - 1:-1], final, table)
            for x, f in zip(xs, firsts)]


# -------------------------------------------------------------- training
def loss(model: Model, params: Dict, tokens: torch.Tensor,
         rows: Optional[slice] = None):
    """(mean next-token cross entropy + aux_weight * summed aux, the cross
    entropy alone) over tokens (B, L); each layer recomputed in the
    backward pass, the head and loss a block of rows at a time."""
    if rows is not None:
        tokens = tokens[rows]
    b, n = tokens.shape
    pos = torch.arange(n, device=tokens.device)
    x = model.embed(params["embed"], tokens)
    aux = torch.zeros((), device=x.device)

    def layer(x, lp):
        x = model.attn_block(x, lp, pos)
        return model.ffn_block(x, lp)

    for p in params["blocks"]:
        x, a = ckpt.checkpoint(layer, x, p["l0"], use_reentrant=False)
        if a is not None:
            aux = aux + a
    h = x[:, :-1].reshape(-1, model.d)
    tgt = tokens[:, 1:].reshape(-1).long()

    def ce(hh, tt):
        lg = model.logits(hh, params["final_norm"]["scale"], params["embed"])
        return F.cross_entropy(lg, tt, reduction="sum")

    total = sum(ckpt.checkpoint(ce, h[i:i + 4096], tgt[i:i + 4096],
                                use_reentrant=False)
                for i in range(0, h.shape[0], 4096))
    nll = total / h.shape[0]
    return nll + model.aux_weight * aux, nll


def lr_at(opt: dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    r = opt["min_lr_ratio"]
    return opt["lr"] * warm * (r + (1 - r) * cos)


def _tree(paths_values):
    tree: Dict = {}
    for path, v in paths_values:
        node = tree
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    tree["blocks"] = [tree["blocks"][str(i)]
                      for i in range(len(tree["blocks"]))]
    return tree


def train(model: Model, init: List, batches: List, opt: dict,
          store_dtypes: Dict[str, torch.dtype], half_batch: bool = False
          ) -> Dict:
    """AdamW steps from `init` ((path, tensor) leaves) on `batches`
    (tokens (B, L) on the device): fp32 gradients, moments and update,
    each param stored back in its configuration dtype (`store_dtypes`:
    bf16 matrices, fp32 norms and router) after every step, as the
    configuration keeps it. Weight decay on leaves of 2 or more dims,
    global-norm clipping, warmup then cosine.

    half_batch: the planted fault "half of the batch left out, the mean
    taken over the rest".

    Returns {"loss": [per step], "grad_norm": {path: first clipped
    gradient's norm}, "change": {path: norm of (params after the steps -
    init)}}."""
    paths = [p for p, _ in init]
    store = [t.detach().to(store_dtypes[p]).clone() for p, t in init]
    mu = [torch.zeros(t.shape, device=t.device) for t in store]
    nu = [torch.zeros(t.shape, device=t.device) for t in store]
    b1, b2 = opt["beta1"], opt["beta2"]
    out = {"loss": [], "grad_norm": {}, "change": {}}
    for step, tokens in enumerate(batches, start=1):
        leaves = [t.float().requires_grad_(True) for t in store]
        params = _tree(zip(paths, leaves))
        rows = slice(0, tokens.shape[0] // 2) if half_batch else None
        total, nll = loss(model, params, tokens, rows)
        grads = torch.autograd.grad(total, leaves)
        out["loss"].append(nll.item())
        with torch.no_grad():
            gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
            clip = min(1.0, opt["grad_clip"] / (float(gnorm) + 1e-9))
            lr = lr_at(opt, step)
            for i, (p, g) in enumerate(zip(leaves, grads)):
                g = g * clip
                if step == 1:
                    out["grad_norm"][paths[i]] = float(g.norm())
                mu[i].mul_(b1).add_((1 - b1) * g)
                nu[i].mul_(b2).add_((1 - b2) * g * g)
                delta = (mu[i] / (1 - b1 ** step)) / (
                    torch.sqrt(nu[i] / (1 - b2 ** step)) + opt["eps"])
                if p.dim() >= 2:
                    delta = delta + opt["weight_decay"] * p
                store[i] = (p - lr * delta).to(store[i].dtype)
        del leaves, params, grads
    with torch.no_grad():
        for (p, t0), t in zip(init, store):
            out["change"][p] = float((t.float() - t0.float()).norm())
    return out
