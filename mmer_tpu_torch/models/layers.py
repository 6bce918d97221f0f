"""Building blocks shared by the port's models: the flax-semantics
LayerNorm module and the flax initializer families used for seeded,
port-native weights."""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmer_tpu_torch.ops.fused_blocks import layer_norm

# flax's truncated-normal variance scaling divides by the stddev of a unit
# normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm(dtype=float32)``: eps 1e-6, float32 output."""

    def __init__(self, dim: int, *, device: torch.device | str):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias)


def dense(x: torch.Tensor, lin: nn.Linear, dt: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dt)`` over an ``nn.Linear``'s float32 params: the
    product of the operands cast to ``dt`` is rounded to ``dt`` before the
    bias, cast to ``dt``, is added (in bf16 a second rounding)."""
    y = F.linear(x.to(dt), lin.weight.to(dt))
    return y if lin.bias is None else y + lin.bias.to(dt)


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal``: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


@torch.no_grad()
def init_like_flax(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every Linear and Conv1d weight of ``module`` from flax's Dense /
    Conv default (``lecun_normal``, zero bias); LayerNorms start at
    (1, 0).  Parameters outside these layers are left to the caller."""
    for mod in module.modules():
        if isinstance(mod, nn.Linear):
            lecun_normal_(mod.weight, mod.in_features, generator)
        elif isinstance(mod, nn.Conv1d):
            lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
        elif isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            continue
        else:
            continue
        if mod.bias is not None:
            mod.bias.zero_()


def param_generator(seed: int, device: torch.device | str) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def load_or_save_params(model: nn.Module, params: Optional[dict],
                        params_path: Optional[str]) -> None:
    """Load ``params`` (a state dict) into ``model``; else load the ``.npz``
    at ``params_path`` if it exists, or save the model's weights there."""
    if params is None and params_path:
        if os.path.exists(params_path):
            with np.load(params_path) as z:
                params = {k: torch.from_numpy(z[k]) for k in z.files}
        else:
            np.savez(params_path, **{k: v.detach().cpu().numpy()
                                     for k, v in model.state_dict().items()})
    if params is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
