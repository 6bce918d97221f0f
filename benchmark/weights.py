"""Seeded weights: one state dict, made on the device, that the program under
test and the plain reference both take.

A reference module's ``param_shapes(m)`` lists each parameter's name (the
key the port's module takes), shape and kind.  All of them are cut from one
``torch.randn`` draw of a generator on the device, seeded by ``--seed``, and
scaled by kind:

- ``dense``: a weight, standard deviation ``1/sqrt(fan_in)`` (LeCun normal,
  the scale of the seeded projections the port serves);
- ``bias``, ``ln_bias``: 0.02;
- ``ln_weight``: 1 + 0.05 x a unit normal;
- ``embed``: 0.02 (the CLS token and the positional embedding, ViT's init).

Biases and LayerNorm params are not left at 0 and 1, so that a program that
drops one differs from the reference.  Every value is then rounded to the
configuration's compute dtype: a bf16 configuration's weights are a bf16
checkpoint, held in float32 as the port's modules hold their params, so the
port's casts to bf16 are exact and program and reference compute with the
same values.
"""

from __future__ import annotations

import math

import torch

SCALE = {"bias": 0.02, "ln_bias": 0.02, "ln_weight": 0.05, "embed": 0.02}


def generator(seed: int, device: torch.device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for ``seed`` (any whole number up to 2**63);
    ``stream`` picks an independent draw for the same seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63))
    return gen


def make_state(shapes: dict, seed: int, device: torch.device,
               values: torch.dtype = torch.float32) -> dict:
    """``{name: float32 tensor on device}`` for ``shapes`` (``name: (shape,
    kind, fan_in)``), cut from one draw, every value rounded to one that
    ``values`` holds exactly."""
    sizes = [math.prod(shape) for shape, _, _ in shapes.values()]
    flat = torch.randn(sum(sizes), generator=generator(seed, device),
                       device=device, dtype=torch.float32)
    state, offset = {}, 0
    for (name, (shape, kind, fan_in)), n in zip(shapes.items(), sizes):
        z = flat[offset:offset + n].view(shape)
        offset += n
        if kind == "dense":
            z = z * fan_in ** -0.5
        elif kind == "ln_weight":
            z = 1.0 + SCALE[kind] * z
        else:
            z = z * SCALE[kind]
        state[name] = z.to(values).float()
    return state


def values_of(model: dict) -> torch.dtype:
    """The dtype whose values a configuration's weights take: its compute
    dtype."""
    return torch.bfloat16 if model["compute_dtype"] == "bfloat16" else torch.float32
