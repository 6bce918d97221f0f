"""Building blocks shared by the port's models: the flax-semantics
LayerNorm module, flax's ``Dense`` rounding, and the extractors' params
files."""

from __future__ import annotations

import os
from typing import Callable, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmer_tpu_torch.core import msgpack
from mmer_tpu_torch.ops.fused_blocks import layer_norm
from mmer_tpu_torch.utils.profiling import cast


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm(dtype=float32)``: eps 1e-6, float32 output."""

    def __init__(self, dim: int, *, device: torch.device | str):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias)


def refuse_kernel_limit(name: str, device, limit: str | None) -> None:
    """Raise ValueError at construction when a module that will launch CUDA
    kernels on ``device`` has a config whose ``limit`` (the first kernel
    limit it breaks, or None) would make a forward raise."""
    if limit and torch.device(device).type == "cuda":
        raise ValueError(f"{name}: {limit}; the plain path (use_kernels=False) "
                         "takes this config")


def dense(x: torch.Tensor, lin: nn.Linear, dt: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dt)`` over an ``nn.Linear``'s float32 params: the
    product of the operands cast to ``dt`` is rounded to ``dt`` before the
    bias, cast to ``dt``, is added (in bf16 a second rounding)."""
    y = F.linear(x.to(dt), cast(lin.weight, dt))
    return y if lin.bias is None else y + cast(lin.bias, dt)


def read_params(path: str, from_flax: Callable[[Mapping], dict]) -> dict:
    """A params file → a state dict: a flax ``.msgpack`` of the JAX model's
    params (as ``mmer_tpu.train.checkpoint.save_params_msgpack`` writes it)
    through ``from_flax``, or an ``.npz`` of the state dict."""
    if path.endswith(".msgpack"):
        with open(path, "rb") as f:
            return from_flax(msgpack.unpackb(f.read()))
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k]) for k in z.files}


def write_params(path: str, state: Mapping[str, torch.Tensor],
                 to_flax: Callable[[Mapping], dict]) -> None:
    """A state dict → a params file: ``.msgpack`` in the JAX layout (the
    tree ``to_flax`` gives, readable by ``load_params_msgpack``), else
    ``.npz``.  Written to a temporary name and renamed, so that the ranks
    of a world, which may all write the same seeded weights, never read a
    part-written file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        if path.endswith(".msgpack"):
            f.write(msgpack.packb(to_flax(state)))
        else:
            np.savez(f, **{k: v.detach().cpu().numpy() for k, v in state.items()})
    os.replace(tmp, path)


def load_or_save_params(make: Callable[[], nn.Module],
                        init: Callable[[], nn.Module],
                        params: Optional[Mapping], params_path: Optional[str], *,
                        from_flax: Callable[[Mapping], dict],
                        to_flax: Callable[[Mapping], dict]) -> nn.Module:
    """An extractor in evaluation mode: ``make()`` with ``params`` (a state
    dict) loaded; else with the params file at ``params_path`` if it exists
    (:func:`read_params`); else ``init()``, the JAX package's seeded weights,
    written to ``params_path`` when one is named (:func:`write_params`).  A
    ``.npz`` written before the port drew JAX's weights holds torch-drawn
    ones: delete it to return to the seeded default."""
    if params is None and params_path and os.path.exists(params_path):
        params = read_params(params_path, from_flax)
    if params is None:
        model = init()
        if params_path:
            write_params(params_path, model.state_dict(), to_flax)
        return model.eval()
    model = make()
    model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
    return model.eval()
