"""Mamba2 SSD (state-space duality) layer, chunked block form (the port of
the JAX package's `core/ssm.py`).

Within a chunk the SSD is a decay-masked quadratic attention; across chunks
a linear recurrence carries the (H, P, S) state. The JAX module has no
Pallas kernel (einsums, `cumsum` and a `lax.scan`), so this one is plain
PyTorch with the JAX module's rounding points:

  * the SSD runs in fp32; `mamba_block` casts `y` back to the model dtype
    before the gated `rmsnorm` (default eps 1e-6, not the config's);
  * `_causal_conv` runs in the input dtype, summing the taps in order and
    adding the bias last; `mamba_decode`'s conv runs in fp32;
  * `dt` is softplus(dt + dt_bias) in fp32.

One departure: `ssd_chunked` masks the intra-chunk decay BEFORE the
exponential (`exp(-inf) = 0`), where the JAX module takes exp of every
entry and then selects. The kept values and the forward are the same, but
above the diagonal the decay sum can exceed 88 (exp overflows to inf) and
the JAX backward then computes 0 * inf = NaN; here the gradient stays
finite.

Shapes follow the Mamba2 paper: x (B, L, H, P); B̄, C (B, L, G, S) shared
across H/G heads; dt (B, L, H); A (H,) negative decay. `ssd_chunked` is the
production path; `ssd_scan_ref` is the token-by-token recurrence oracle.

`mamba_decode` updates its cache ("conv", "ssm") IN PLACE, without a host
sync: under the serving engine's CUDA graphs both leaves are carries.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.layers import _dense_init, init_rmsnorm, rmsnorm
from repro_torch.core.types import SSMSpec

Params = Dict[str, Any]


def ssd_scan_ref(x, dt, a, b_mat, c_mat, d_skip):
    """Sequential recurrence oracle, fp32.
    x: (B,L,H,P) dt: (B,L,H) a: (H,) b,c: (B,L,G,S) d: (H,).
    state s: (B,H,P,S); s_t = exp(dt*a) s_{t-1} + dt * x ⊗ b;
    y = s · c + d*x
    """
    bsz, l, h, p = x.shape
    rep = h // b_mat.shape[2]
    bm = b_mat.repeat_interleave(rep, dim=2).float()        # (B,L,H,S)
    cm = c_mat.repeat_interleave(rep, dim=2).float()
    xf, dtf = x.float(), dt.float()
    s = torch.zeros((bsz, h, p, b_mat.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(l):
        decay = torch.exp(dtf[:, t] * a)[..., None, None]    # (B,H,1,1)
        upd = (dtf[:, t, :, None] * xf[:, t])[..., None] * bm[:, t, :, None, :]
        s = s * decay + upd
        ys.append(torch.einsum("bhps,bhs->bhp", s, cm[:, t]))
    y = torch.stack(ys, dim=1)                              # (B,L,H,P)
    return y + d_skip[None, None, :, None] * xf


def ssd_chunked(x, dt, a, b_mat, c_mat, d_skip, chunk: int = 256):
    """Chunked SSD: the output of `ssd_scan_ref` with O(L * chunk) intra
    work and an O(L / chunk) sequential scan over the chunk states."""
    bsz, l, h, p = x.shape
    g, s_dim = b_mat.shape[2], b_mat.shape[3]
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
    lp = l + pad
    nc = lp // chunk
    rep = h // g

    xf = x.reshape(bsz, nc, chunk, h, p).float()
    dtf = dt.reshape(bsz, nc, chunk, h).float()
    bf = b_mat.reshape(bsz, nc, chunk, g, s_dim).float()
    cf = c_mat.reshape(bsz, nc, chunk, g, s_dim).float()
    bf = bf.repeat_interleave(rep, dim=3)                   # (B,N,Q,H,S)
    cf = cf.repeat_interleave(rep, dim=3)

    da = dtf * a                                            # (B,N,Q,H)
    cum = torch.cumsum(da, dim=2)                           # inclusive
    seg_total = cum[:, :, -1]                               # (B,N,H)

    # intra-chunk: y[i] = sum_{j<=i} exp(cum_i - cum_j) * (C_i·B_j) dt_j x_j;
    # masked before the exponential, so the masked entries are exactly 0
    # and carry no inf into the backward pass
    dmat = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,N,Q,Q,H)
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()
    lmat = torch.exp(dmat.masked_fill(~mask[:, :, None], float("-inf")))
    scores = torch.einsum("bnqhs,bnkhs->bnqkh", cf, bf) * lmat
    xbar = xf * dtf[..., None]                              # (B,N,Q,H,P)
    y_intra = torch.einsum("bnqkh,bnkhp->bnqhp", scores, xbar)

    # chunk states: S_n = sum_j exp(seg_total - cum_j) dt_j B_j ⊗ x_j
    w = torch.exp(seg_total[:, :, None] - cum)              # (B,N,Q,H)
    state_n = torch.einsum("bnqh,bnqhs,bnqhp->bnhps", w, bf, xbar)

    # inter-chunk recurrence over N: the state entering each chunk
    s = torch.zeros((bsz, h, p, s_dim), dtype=torch.float32, device=x.device)
    prevs = []
    for n in range(nc):
        prevs.append(s)
        s = s * torch.exp(seg_total[:, n])[..., None, None] + state_n[:, n]
    s_prevs = torch.stack(prevs, dim=1)                     # (B,N,H,P,S)

    # inter-chunk contribution: y += exp(cum_i) * C_i · S_prev
    y_inter = torch.einsum("bnqhs,bnhps->bnqhp",
                           cf * torch.exp(cum)[..., None], s_prevs)
    y = (y_intra + y_inter).reshape(bsz, lp, h, p)[:, :l]
    return y + d_skip[None, None, :, None] * x.reshape(bsz, lp, h, p)[:, :l]


# ------------------------------------------------------------ full block ---

def init_mamba(gen: torch.Generator, d_model: int, spec: SSMSpec, dtype,
               device) -> Params:
    """The JAX `init_mamba`'s leaves and distributions, drawn from `gen`:
    truncated-normal fan-in projections, the conv taps at scale 0.5, and
    fp32 `a_log` = log(linspace(1, 16, H)), `d_skip` = 1, `dt_bias` (the
    inverse softplus of dt drawn log-uniform in [1e-3, 0.1]) and norm."""
    di = spec.d_inner(d_model)
    h = spec.num_heads(d_model)
    g, s = spec.num_groups, spec.state_dim
    conv_dim = di + 2 * g * s
    in_proj = _dense_init(gen, (d_model, 2 * di + 2 * g * s + h), dtype,
                          device)
    conv_w = _dense_init(gen, (spec.conv_width, conv_dim), dtype, device,
                         scale=0.5)
    u = torch.rand((h,), generator=gen, device=device, dtype=torch.float32)
    lo, hi = math.log(0.001), math.log(0.1)
    dt0 = torch.exp(u * (hi - lo) + lo)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                          device=device)),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=device),
        "dt_bias": torch.log(torch.expm1(dt0)),
        "norm": init_rmsnorm(di, device),
        "out_proj": _dense_init(gen, (di, d_model), dtype, device),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv in x's dtype. x: (B, L, C); w: (K, C). The taps
    are summed in order, ((x0 w0 + x1 w1) + x2 w2) + ..., each product and
    sum rounded to x's dtype, and the bias added last."""
    k, l = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:l] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + l] * w[i]
    return out + b


def mamba_inputs(params: Params, x, spec: SSMSpec) -> Dict[str, Any]:
    """The mixer's inputs to the SSD, x: (B, L, Dm): the gate z, the conv
    input (the pre-conv x and B/C channels, the prefill cache's conv
    window), the post-conv heads xh (B, L, H, P), b, c (B, L, G, S) and
    dt = softplus(dt + dt_bias) (B, L, H) in fp32. `mamba_block` and the
    prefill cache (`model._mamba_prefill_cache`) share one evaluation."""
    bsz, l, dm = x.shape
    di = spec.d_inner(dm)
    h = spec.num_heads(dm)
    g, s = spec.num_groups, spec.state_dim
    zxbcdt = x @ params["in_proj"]
    z, xin, bc, dt = torch.split(zxbcdt, [di, di, 2 * g * s, h], dim=-1)
    conv_in = torch.cat([xin, bc], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, params["conv_w"],
                                   params["conv_b"]))
    xin, b_mat, c_mat = torch.split(conv_out, [di, g * s, g * s], dim=-1)
    return {"z": z, "conv_in": conv_in,
            "xh": xin.reshape(bsz, l, h, spec.head_dim),
            "b": b_mat.reshape(bsz, l, g, s),
            "c": c_mat.reshape(bsz, l, g, s),
            "dt": F.softplus(dt.float() + params["dt_bias"])}


def mamba_block(params: Params, x, spec: SSMSpec, *, chunk: int = 256,
                inputs: Optional[Dict[str, Any]] = None):
    """Full Mamba2 mixer. x: (B, L, Dm) -> (B, L, Dm). `inputs`: x's
    `mamba_inputs`, when the caller has them already."""
    bsz, l, dm = x.shape
    di = spec.d_inner(dm)
    m = mamba_inputs(params, x, spec) if inputs is None else inputs
    a = -torch.exp(params["a_log"])
    y = ssd_chunked(m["xh"], m["dt"], a, m["b"], m["c"], params["d_skip"],
                    chunk=chunk)
    y = y.reshape(bsz, l, di).to(x.dtype)
    y = rmsnorm(params["norm"], y * F.silu(m["z"]))
    return y @ params["out_proj"]


# ------------------------------------------------------------ decode -------

def init_mamba_cache(d_model: int, spec: SSMSpec, batch: int, dtype,
                     device) -> Dict[str, torch.Tensor]:
    """Zeroed decode state: the last K-1 conv inputs (model dtype) and the
    (B, H, P, S) SSM state (fp32)."""
    di = spec.d_inner(d_model)
    h = spec.num_heads(d_model)
    conv_dim = di + 2 * spec.num_groups * spec.state_dim
    return {
        "conv": torch.zeros((batch, spec.conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, h, spec.head_dim, spec.state_dim),
                           dtype=torch.float32, device=device),
    }


def mamba_decode(params: Params, x, cache, spec: SSMSpec):
    """Single-token recurrent step. x: (B, 1, Dm). O(1) state, the SSM
    counterpart of the ring KV cache. Updates cache["conv"] and
    cache["ssm"] IN PLACE (the window shifts through a temporary) and
    returns (y (B, 1, Dm), cache)."""
    bsz, _, dm = x.shape
    di = spec.d_inner(dm)
    h = spec.num_heads(dm)
    g, s = spec.num_groups, spec.state_dim

    zxbcdt = x[:, 0] @ params["in_proj"]
    z, xin, bc, dt = torch.split(zxbcdt, [di, di, 2 * g * s, h], dim=-1)
    conv_in = torch.cat([xin, bc], dim=-1)                  # (B, C)
    window = torch.cat([cache["conv"], conv_in[:, None, :]], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window.float(),
                            params["conv_w"].float())
    conv_out = F.silu(conv_out + params["conv_b"].float())
    xin, b_mat, c_mat = torch.split(conv_out, [di, g * s, g * s], dim=-1)
    xh = xin.reshape(bsz, h, spec.head_dim)
    b_mat = b_mat.reshape(bsz, g, s).repeat_interleave(h // g, dim=1)
    c_mat = c_mat.reshape(bsz, g, s).repeat_interleave(h // g, dim=1)
    dt = F.softplus(dt.float() + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    y = ssm_update(cache["ssm"], xh, dt, a, b_mat, c_mat)
    y = y + params["d_skip"][None, :, None] * xh
    y = y.reshape(bsz, 1, di).to(x.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z[:, None, :]))
    cache["conv"].copy_(window[:, 1:])
    return y @ params["out_proj"], cache


def ssm_update(state, xh, dt, a, b_mat, c_mat):
    """One step of the recurrence on the (B, H, P, S) fp32 state, IN PLACE:
    state <- exp(dt a) state + dt x ⊗ b; returns y = state · c (B, H, P).
    xh (B, H, P), dt (B, H), a (H,), b_mat / c_mat (B, H, S), all fp32."""
    decay = torch.exp(dt * a)[..., None, None]              # (B,H,1,1)
    upd = (dt[..., None] * xh)[..., None] * b_mat[:, :, None, :]
    new = state * decay + upd
    state.copy_(new)
    return torch.einsum("bhps,bhs->bhp", new, c_mat)
