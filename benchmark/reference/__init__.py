"""Plain float32 PyTorch references of the benchmark's models, with the host
semantics of the entries the cells drive.  They import nothing of the
program under test and nothing of the JAX package; they take the benchmark's
seeded state dict and inputs and work out every derived state themselves.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_float32():
    """float32 products in float32: TF32 off for matmuls and cuDNN
    convolutions, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis with the biased variance and eps 1e-6
    (flax's, which the port keeps; PyTorch's default eps is 1e-5)."""
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU with the exact erf."""
    return 0.5 * x * (1.0 + torch.erf(x / 2.0 ** 0.5))
