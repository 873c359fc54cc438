"""PyTorch/CUDA port of the SWAT serving path (the JAX package `repro` is
the reference it is tested against; this package imports nothing of it).

Numerics contract: float32 matrix products and convolutions run in full
float32, never TF32. PyTorch's default already keeps matmuls out of TF32,
but cuDNN convolutions default to TF32, so both flags are pinned here,
once, when the package is imported.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
