"""Convert a HuggingFace Wav2Vec2 checkpoint into the port's Wav2Vec2 params:
the port of ``mmer_tpu/models/port_wav2vec2.py`` and of
``mmer_tpu.models.wav2vec2.convert_hf_state``.

The reference embeds audio with HF
``audeering/wav2vec2-large-robust-12-ft-emotion-msp-dim``.  With that
checkpoint's files in a local directory (``config.json`` and
``model.safetensors`` or ``pytorch_model.bin``), this tool writes a params
file that ``AudioEmbedder(params_path=...)`` and the server's
``--wav_params`` load:

    python -m mmer_tpu_torch.models.port_wav2vec2 --hf DIR --out wav2vec2.msgpack

``.msgpack`` is the JAX package's layout (its ``AudioEmbedder`` reads the same
file), ``.npz`` the port's state dict.  The tool reads only a local
directory: it imports no ``transformers`` and fetches nothing.  Only the
robust variant the port computes is taken (stable layer norm, layer-normed
conv encoder with biases, GELU).
"""

from __future__ import annotations

import argparse
import json
import os
import struct
from typing import Dict, Mapping

import torch

from mmer_tpu_torch.config import Wav2Vec2Config
from mmer_tpu_torch.models.convert import wav2vec2_to_flax
from mmer_tpu_torch.models.layers import write_params

# The safetensors dtype names of the tensors a checkpoint may hold.
_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file → its tensors.  The format: a little-endian
    u64 header length, a JSON header mapping each name to its ``dtype``,
    ``shape`` and ``data_offsets`` (begin, end) into the raw little-endian
    bytes that follow (``__metadata__`` aside)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                             "which this reader does not take")
        begin, end = info["data_offsets"]
        count = 1
        for d in info["shape"]:
            count *= d
        size = torch.empty((), dtype=dtype).element_size()
        if not 0 <= begin <= end <= len(data) or end - begin != count * size:
            raise ValueError(f"{path}: {name}'s data_offsets {begin}:{end} do "
                             f"not hold {info['shape']} {info['dtype']}")
        flat = (torch.frombuffer(data, dtype=dtype, count=count, offset=begin)
                if count else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(info["shape"])
    return out


def config_from_hf(hf: Mapping) -> Wav2Vec2Config:
    """An HF ``Wav2Vec2Config`` (its ``config.json`` as a dict) → the port's
    config, refusing what the port does not compute."""
    wanted = {"do_stable_layer_norm": True, "feat_extract_norm": "layer",
              "conv_bias": True, "hidden_act": "gelu",
              "feat_extract_activation": "gelu"}
    for key, value in wanted.items():
        if hf.get(key, value) != value:
            raise ValueError(f"the port's Wav2Vec2 computes {key}={value!r}, "
                             f"the checkpoint has {hf.get(key)!r}")
    return Wav2Vec2Config(
        hidden_dim=hf["hidden_size"], num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"], ffn_dim=hf["intermediate_size"],
        conv_dims=tuple(hf["conv_dim"]), conv_strides=tuple(hf["conv_stride"]),
        conv_kernels=tuple(hf["conv_kernel"]),
        num_conv_pos_embeddings=hf["num_conv_pos_embeddings"],
        num_conv_pos_embedding_groups=hf["num_conv_pos_embedding_groups"],
        do_stable_layer_norm=hf["do_stable_layer_norm"],
        feat_extract_norm=hf["feat_extract_norm"])


def _pos_conv_weight(sd: Mapping[str, torch.Tensor], prefix: str) -> torch.Tensor:
    """The positional conv's weight with its weight norm folded in, as HF
    materialises ``.weight``: ``torch._weight_norm(v, g, dim=2)``."""
    for g, v in (("parametrizations.weight.original0",
                  "parametrizations.weight.original1"), ("weight_g", "weight_v")):
        if f"{prefix}.{g}" in sd:
            return torch._weight_norm(sd[f"{prefix}.{v}"].float(),
                                      sd[f"{prefix}.{g}"].float(), 2)
    return sd[f"{prefix}.weight"]


def convert_hf_state(state_dict: Mapping[str, torch.Tensor],
                     cfg: Wav2Vec2Config) -> Dict[str, torch.Tensor]:
    """A ``transformers`` ``Wav2Vec2Model`` state dict (keys with or without
    the ``wav2vec2.`` prefix of a model with a head) → the port's
    ``Wav2Vec2Encoder`` state dict, float32."""
    sd = {k[len("wav2vec2."):] if k.startswith("wav2vec2.") else k: v
          for k, v in state_dict.items()}
    out: Dict[str, torch.Tensor] = {}

    def take(dst: str, src: str, names=("weight", "bias")) -> None:
        for n in names:
            out[f"{dst}.{n}"] = sd[f"{src}.{n}"].float().contiguous()

    for i in range(len(cfg.conv_dims)):
        take(f"feature_encoder.convs.{i}", f"feature_extractor.conv_layers.{i}.conv")
        take(f"feature_encoder.norms.{i}",
             f"feature_extractor.conv_layers.{i}.layer_norm")
    take("proj_norm", "feature_projection.layer_norm")
    take("proj", "feature_projection.projection")
    out["pos_conv.conv.weight"] = _pos_conv_weight(
        sd, "encoder.pos_conv_embed.conv").float().contiguous()
    take("pos_conv.conv", "encoder.pos_conv_embed.conv", ("bias",))
    for i in range(cfg.num_layers):
        src, dst = f"encoder.layers.{i}", f"layers.{i}"
        take(f"{dst}.norm_attn", f"{src}.layer_norm")
        for n in ("q", "k", "v", "out"):
            take(f"{dst}.{n}", f"{src}.attention.{n}_proj")
        take(f"{dst}.norm_ffn", f"{src}.final_layer_norm")
        take(f"{dst}.ffn_in", f"{src}.feed_forward.intermediate_dense")
        take(f"{dst}.ffn_out", f"{src}.feed_forward.output_dense")
    take("final_norm", "encoder.layer_norm")
    return out


def load_hf_dir(hf_dir: str):
    """A local HF checkpoint directory → (the port's config, the port's
    state dict)."""
    if not os.path.isdir(hf_dir):
        raise SystemExit(f"port_wav2vec2: {hf_dir!r} is not a local directory; "
                         "this tool reads a checkpoint's files (config.json and "
                         "model.safetensors or pytorch_model.bin) from disk and "
                         "downloads nothing")
    with open(os.path.join(hf_dir, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    st = os.path.join(hf_dir, "model.safetensors")
    if os.path.exists(st):
        state = read_safetensors(st)
    else:
        state = torch.load(os.path.join(hf_dir, "pytorch_model.bin"),
                           map_location="cpu", weights_only=True)
    return cfg, convert_hf_state(state, cfg)


def port(hf_dir: str, out_path: str) -> Wav2Vec2Config:
    """Convert the checkpoint in ``hf_dir`` and write ``out_path``
    (``.msgpack`` in the JAX layout, else ``.npz``)."""
    cfg, sd = load_hf_dir(hf_dir)
    write_params(out_path, sd, lambda s: wav2vec2_to_flax(s, cfg.num_heads))
    return cfg


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--hf", required=True,
                   help="local HF checkpoint directory (config.json and "
                        "model.safetensors or pytorch_model.bin)")
    p.add_argument("--out", required=True,
                   help="output params file: .msgpack (the JAX layout) or .npz")
    args = p.parse_args(argv)
    cfg = port(args.hf, args.out)
    print(f"ported {args.hf} -> {args.out}")
    print(f"config: {cfg}")


if __name__ == "__main__":
    main()
