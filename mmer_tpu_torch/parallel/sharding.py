"""Tensor parallelism of the fusion model over a mesh's model axis, the port
of ``mmer_tpu/parallel/sharding.py``.

The same Megatron pairing as the JAX rules, over the port's parameter names
(``models/fusion.py``):

- ``self_attn.{query,key,value}``: column-parallel over heads (the weight's
  output rows and the bias; JAX keeps the (h, hd) biases replicated and lets
  XLA slice them, the port's local heads need their slice);
- ``self_attn.out``: row-parallel (the weight's input columns; the bias is
  added once, after the reduction);
- ``ffn_in``: column-parallel, its bias split the same way;
- ``ffn_out``: row-parallel;
- everything else replicated.

Each pair costs one all-reduce over the model group in the forward (after
the row-parallel product, :func:`reduce_from_model`) and one in the backward
(before the column-parallel product, :func:`copy_to_model`): two small
``torch.autograd.Function`` s, no ``DTensor``.  Replicated parameters get
whole gradients on every model rank, sharded ones their shard's.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from mmer_tpu_torch.core.mesh import Mesh

def fusion_param_spec(name: str, tensor: torch.Tensor) -> Optional[int]:
    """The dim along which a fusion parameter (a state-dict name) is split
    over the model axis, or None when it is replicated."""
    parts = name.split(".")
    if len(parts) < 2 or parts[-1] not in ("weight", "bias"):
        return None
    module, leaf = parts[-2], parts[-1]
    in_attn = "self_attn" in parts
    if (module in ("query", "key", "value") and in_attn) or module == "ffn_in":
        return 0 if tensor.ndim in (1, 2) else None
    if ((module == "out" and in_attn) or module == "ffn_out") and leaf == "weight":
        return 1 if tensor.ndim == 2 else None
    return None


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        ctx.mesh.all_reduce(grad, "model")
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """The partial products summed over the model group; identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        out = x.contiguous().clone()
        mesh.all_reduce(out, "model")
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumOverData(torch.autograd.Function):
    """Summed over the data group, forward and backward: a statistic of the
    global batch whose gradient reaches every rank's rows."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        out = x.contiguous().clone()
        mesh.all_reduce(out, "data")
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        ctx.mesh.all_reduce(grad, "data")
        return grad, None


def copy_to_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    return x if mesh is None else _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    return x if mesh is None else _ReduceFromModel.apply(x, mesh)


def sum_over_data(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    return x if mesh is None else _SumOverData.apply(x, mesh)


def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Turn a full fusion model into this rank's shard, in place: the split
    parameters (:func:`fusion_param_spec`) keep this rank's slice, the
    attention modules their ``heads / mp`` heads, and the modules that pair
    them hold the mesh.  BatchNorm layers get it too, for the data axis.
    A model on a one-rank model axis keeps its parameters whole; with an
    active mesh its BatchNorm layers still reduce over the data axis."""
    from mmer_tpu_torch.models.fusion import (BatchNorm, MultiHeadSelfAttention,
                                              PostNormEncoderLayer)

    for module in model.modules():
        if isinstance(module, BatchNorm) and mesh.active:
            module.mesh = mesh
    if mesh.mp == 1:
        return model
    with torch.no_grad():
        for name, param in list(model.named_parameters()):
            dim = fusion_param_spec(name, param)
            if dim is None:
                continue
            owner = model.get_submodule(name.rsplit(".", 1)[0])
            keep = nn.Parameter(param.narrow(
                dim, mesh.model_cols(param.shape[dim]).start,
                param.shape[dim] // mesh.mp).clone())
            keep.tp_dim = dim       # clip_by_global_norm sums its norm over the axis
            setattr(owner, name.rsplit(".", 1)[1], keep)
    for module in model.modules():
        if isinstance(module, MultiHeadSelfAttention):
            if module.num_heads % mesh.mp:
                raise ValueError(f"{module.num_heads} heads do not split over "
                                 f"{mesh.mp} model ranks")
            module.num_heads //= mesh.mp
            module.tp = mesh
        elif isinstance(module, PostNormEncoderLayer):
            module.tp = mesh
    return model


def gather_params(state: Dict[str, torch.Tensor], mesh: Optional[Mesh]
                  ) -> Dict[str, torch.Tensor]:
    """A sharded state dict → the full one (every model rank gets it): each
    split tensor all-gathered over the model group and concatenated along
    its dim.  The identity off a model axis."""
    if mesh is None or mesh.mp == 1:
        return state
    out = {}
    for name, t in state.items():
        dim = fusion_param_spec(name, t)
        if dim is None:
            out[name] = t
            continue
        parts = [torch.empty_like(t) for _ in range(mesh.mp)]
        dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
        out[name] = torch.cat(parts, dim=dim)
    return out

