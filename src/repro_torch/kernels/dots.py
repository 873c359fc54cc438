"""fp32-accumulate products (the port of the JAX package's `kernels/dots.py`).

The JAX helper asks XLA for bf16 x bf16 -> f32 dots, and upcasts the
operands instead where the backend cannot execute that combination. The
port has the same switch:

  native_mixed_dot(False)  the default: operands are upcast to float32
                           first, and the result is the fp32-accumulated
                           product of the same values (the CPU has no
                           mixed-output product kernel).
  native_mixed_dot(True)   the dry-run (`launch/dryrun.py`): bf16 operands
                           stay bf16 and the product returns fp32 through
                           `aten::bmm.dtype` / `aten::mm.dtype`, so the
                           cost counter charges no fp32 operand copies. On
                           CPU tensors, which have no such kernel, the
                           operands are still upcast.

This is used by the plain (reference) attention versions and the model's
head product; the CUDA kernels accumulate in fp32 in registers, and the
model's projections stay `x @ W` in the model dtype.
"""
from __future__ import annotations

import torch

_NATIVE = False


def native_mixed_dot(value: bool) -> None:
    global _NATIVE
    _NATIVE = bool(value)


def native(a: torch.Tensor) -> bool:
    """Whether a product of `a` keeps its (non-fp32) operands as they are."""
    return _NATIVE and a.dtype != torch.float32 and a.device.type != "cpu"


class _MixedBmm(torch.autograd.Function):
    """a (B, M, K) @ b (B, K, N) in the operands' dtype, accumulated and
    returned in fp32; each gradient is the mixed product of the cotangent
    rounded to the operands' dtype (XLA's transpose of the mixed dot)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, b.transpose(1, 2),
                           out_dtype=torch.float32).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.transpose(1, 2), g,
                           out_dtype=torch.float32).to(b.dtype)
        return ga, gb


def mixed_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N) with fp32 accumulation and an fp32 result, the
    operands read in their own dtype (differentiable)."""
    return _MixedBmm.apply(a[None], b[None])[0]


def _mixed_einsum(subscripts: str, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """A two-operand einsum as one batched mixed product: the letters of
    both operands and the output are the batch, those of one operand and
    the output its rows or columns, those of both operands only the
    contraction."""
    ins, out = subscripts.replace(" ", "").split("->")
    sa, sb = ins.split(",")
    batch = [c for c in out if c in sa and c in sb]
    rows = [c for c in out if c in sa and c not in sb]
    cols = [c for c in out if c in sb and c not in sa]
    red = [c for c in sa if c in sb and c not in out]
    if sorted(batch + rows + red) != sorted(sa) or \
            sorted(batch + cols + red) != sorted(sb):
        raise ValueError(f"mixed einsum {subscripts!r}: a letter summed in "
                         "one operand only")
    size = {}
    for letters, t in ((sa, a), (sb, b)):
        for c, n in zip(letters, t.shape):
            size[c] = max(size.get(c, 1), n)      # a batch dim broadcasts

    def n(letters):
        p = 1
        for c in letters:
            p *= size[c]
        return p

    a3 = a.permute(*[sa.index(c) for c in batch + rows + red])
    a3 = a3.expand(*[size[c] for c in batch + rows + red])
    b3 = b.permute(*[sb.index(c) for c in batch + red + cols])
    b3 = b3.expand(*[size[c] for c in batch + red + cols])
    y = _MixedBmm.apply(a3.reshape(n(batch), n(rows), n(red)),
                        b3.reshape(n(batch), n(red), n(cols)))
    y = y.reshape(*[size[c] for c in batch + rows + cols])
    order = batch + rows + cols
    return y.permute(*[order.index(c) for c in out])


def einsum_f32(subscripts: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with an fp32 result: fp32 operands, or with the native switch
    on, the operands as they are (`native`)."""
    if native(a) and a.dtype == b.dtype:
        return _mixed_einsum(subscripts, a, b)
    return torch.einsum(subscripts, a.float(), b.float())
