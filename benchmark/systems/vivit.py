"""``VideoFeatureExtractor.embed_chunks`` of ``mmer_tpu_torch`` over a
ViViT configuration."""

from __future__ import annotations

import torch

from benchmark import work
from benchmark.systems import Program
from mmer_tpu_torch.config import ViViTConfig
from mmer_tpu_torch.preprocess.extract import VideoFeatureExtractor


def port_config(config: dict) -> ViViTConfig:
    return ViViTConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in config["model"].items()})


def build(config: dict, traffic: dict, state: dict,
          device: torch.device) -> Program:
    ex = VideoFeatureExtractor(port_config(config), device=device,
                               device_batch=traffic["device_batch"], params=state,
                               use_kernels=config["route"]["use_kernels"])
    pipeline = traffic["pipeline"]
    return Program(call=lambda arg: ex.embed_chunks(arg, pipeline=pipeline),
                   target=ex)


def useful(arg, config: dict) -> float:
    return float(len(arg))


def flops(arg, config: dict) -> float:
    return float(len(arg) * work.vivit_chunk_flops(config["model"]))


def forwards(arg, config: dict, traffic: dict) -> list:
    """One forward of ``device_batch`` chunks for each started block of the
    call (the last one padded)."""
    bs = traffic["device_batch"]
    return [{"rows": bs, "tokens": work.vivit_tokens(config["model"])}
            for _ in range(-(-len(arg) // bs))]


def control(program: Program) -> None:
    """The extractor's ViViT replaced by the port's int8 forward of the same
    weights (``models/vivit_quant.py``), fed the call's uint8 pixels."""
    from mmer_tpu_torch.models.vivit_quant import (quant_vivit_apply,
                                                   quantize_vivit_params)

    ex = program.target
    qparams, cfg = quantize_vivit_params(ex.model), ex.cfg

    class Int8ViViT(torch.nn.Module):
        def forward(self, x):
            return quant_vivit_apply(qparams, (x * 255.0).round().to(torch.uint8), cfg)

    ex.model = Int8ViViT()
