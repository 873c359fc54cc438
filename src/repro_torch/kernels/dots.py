"""fp32-accumulate products (the port of the JAX package's `kernels/dots.py`).

The JAX helper asks XLA for bf16 x bf16 -> f32 dots. PyTorch has no
portable mixed-output product, so operands are upcast to float32 first:
the result is the fp32-accumulated product of the same values. This is
used by the plain (reference) attention versions only; the CUDA kernels
accumulate in fp32 in registers, and the model's projections stay
`x @ W` in the model dtype.
"""
from __future__ import annotations

import torch


def einsum_f32(subscripts: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with fp32 operands and an fp32 result."""
    return torch.einsum(subscripts, a.float(), b.float())
