"""Reference ``.pth`` ⇄ the port's fusion state dict, the port of
``mmer_tpu/models/port_fusion.py``.

The reference trainer saves ``model.state_dict()`` of its v2
``MultimodalEmotionModel`` (train2.py:241-292, 766-774).  This module maps
those keys onto the port's :class:`~mmer_tpu_torch.models.fusion.MultimodalEmotionModel`
and back, tensor for tensor and bit for bit:

- ``params_from_state_dict``: reference names → the port's state dict (and
  the config the weights imply);
- ``state_dict_from_params``: the port's state dict → reference names,
  loadable with ``load_state_dict(strict=True)`` into the reference model;
- ``load_pth`` / ``save_pth``: the file-level wrappers;
- ``main``: the converter CLI, reference ``.pth`` ⇄ flax ``.msgpack`` (the
  JAX package's checkpoint format), through the port's own msgpack codec:

      python3 -m mmer_tpu_torch.models.port_fusion ref.pth out.msgpack [--heads 8]
      python3 -m mmer_tpu_torch.models.port_fusion ours.msgpack out.pth

The checkpoint decides the shape: every hyperparameter the weights
determine is read off the tensors (``infer_model_config``), and a config
that disagrees raises instead of serving random weights (the reference's
failure, inference.py:236-265).  ``fusion_heads`` is not weight-determined
(the fused in_proj is ``(3d, d)`` for any head count) and defaults to 8.
Only the v2 LayerNorm model converts; v1 BatchNorm keys raise.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from mmer_tpu_torch.config import ModelConfig

__all__ = ["infer_model_config", "params_from_state_dict",
           "state_dict_from_params", "is_reference_state_dict", "load_pth",
           "save_pth", "config_from_tree", "main"]

StateDict = Dict[str, torch.Tensor]


def _t(x: Any) -> torch.Tensor:
    """A float32 CPU tensor of ``x`` (a tensor or an array)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _require(sd: Mapping[str, Any], key: str) -> torch.Tensor:
    if key not in sd:
        if "fusion.bn_video.weight" in sd or "classifier.fc1.weight" in sd:
            raise NotImplementedError(
                "this looks like a v1 BatchNorm checkpoint (train.py:39-130)"
                " — only the canonical v2 LayerNorm model is convertible")
        raise KeyError(f"reference checkpoint missing key {key!r} — not a "
                       "v2 MultimodalEmotionModel state_dict?")
    return _t(sd[key])


def is_reference_state_dict(sd: Mapping[str, Any]) -> bool:
    """Whether ``sd`` carries the reference's key layout (v1 or v2), rather
    than the port's own."""
    return any(k.startswith(("fusion.transformer.", "classifier.net.",
                             "classifier.fc1.", "fusion.bn_video."))
               for k in sd)


def infer_model_config(sd: Mapping[str, Any], **overrides) -> ModelConfig:
    """Read every weight-determined hyperparameter off the state dict.
    ``overrides`` patches the non-inferable fields (``fusion_heads``,
    dropouts, ``compute_dtype``) or forces inferable ones."""
    vp = _require(sd, "fusion.video_proj.weight")          # (fused, video)
    ap = _require(sd, "fusion.audio_proj.weight")          # (fused, audio)
    pos = _require(sd, "fusion.pos_embed")                 # (1, S, fused)
    l1 = _require(sd, "fusion.transformer.layers.0.linear1.weight")
    h0 = _require(sd, "classifier.net.0.weight")           # (hidden, fused)
    out = _require(sd, "classifier.net.8.weight")          # (classes, hidden)
    if "fusion.norm_video.weight" not in sd:
        raise NotImplementedError(
            "use_layernorm=False checkpoints (Identity norms + BatchNorm1d "
            "classifier, train2.py:104,216) are not supported")
    layers = 0
    while f"fusion.transformer.layers.{layers}.norm1.weight" in sd:
        layers += 1
    inferred = dict(
        video_dim=int(vp.shape[1]), audio_dim=int(ap.shape[1]),
        fused_dim=int(vp.shape[0]), num_classes=int(out.shape[0]),
        max_seq_len=int(pos.shape[1]), fusion_layers=layers,
        fusion_ffn_dim=int(l1.shape[0]),
        classifier_hidden_dim=int(h0.shape[0]), norm="layernorm")
    inferred.update(overrides)
    return ModelConfig(**inferred)


# reference name → the port's name, for the tensors that map one to one
def _one_to_one(cfg: ModelConfig) -> Dict[str, str]:
    names = {
        "fusion.video_proj": "fusion.video_proj",
        "fusion.audio_proj": "fusion.audio_proj",
        "fusion.norm_video": "fusion.norm_video.ln",
        "fusion.norm_audio": "fusion.norm_audio.ln",
        "fusion.out_norm": "fusion.out_norm.ln",
        "classifier.net.0": "classifier.hidden_0",
        "classifier.net.1": "classifier.norm_0.ln",
        "classifier.net.4": "classifier.hidden_1",
        "classifier.net.5": "classifier.norm_1.ln",
        "classifier.net.8": "classifier.out",
    }
    for i in range(cfg.fusion_layers):
        ref, port = f"fusion.transformer.layers.{i}", f"fusion.layers.{i}"
        names.update({f"{ref}.self_attn.out_proj": f"{port}.self_attn.out",
                      f"{ref}.linear1": f"{port}.ffn_in",
                      f"{ref}.linear2": f"{port}.ffn_out",
                      f"{ref}.norm1": f"{port}.norm1",
                      f"{ref}.norm2": f"{port}.norm2"})
    out = {"fusion.pos_embed": "fusion.pos_embed"}
    for ref, port in names.items():
        out[f"{ref}.weight"] = f"{port}.weight"
        out[f"{ref}.bias"] = f"{port}.bias"
    return out


def params_from_state_dict(sd: Mapping[str, Any],
                           cfg: Optional[ModelConfig] = None, *,
                           heads: Optional[int] = None,
                           **overrides) -> Tuple[StateDict, ModelConfig]:
    """Reference v2 state dict → (the port's fusion state dict, config).

    When ``cfg`` is given, its shapes are validated against the weights (a
    mismatch raises); when omitted it is inferred, with ``overrides``
    patching the non-inferable fields.  ``heads`` overrides the head count
    either way."""
    if heads:
        overrides["fusion_heads"] = heads
    inferred = infer_model_config(sd, **overrides)
    if cfg is None:
        cfg = inferred
    else:
        if heads:
            cfg = dataclasses.replace(cfg, fusion_heads=heads)
        mismatch = {
            f: (getattr(cfg, f), getattr(inferred, f))
            for f in ("video_dim", "audio_dim", "fused_dim", "num_classes",
                      "max_seq_len", "fusion_layers", "fusion_ffn_dim",
                      "classifier_hidden_dim")
            if getattr(cfg, f) != getattr(inferred, f)}
        if mismatch:
            raise ValueError(
                "checkpoint/config shape mismatch (the reference serves "
                "random weights on this; we refuse): "
                + ", ".join(f"{k}: cfg {a} vs ckpt {b}"
                            for k, (a, b) in mismatch.items()))
    if cfg.norm != "layernorm":
        raise NotImplementedError("only norm='layernorm' (v2) converts")
    d, h = cfg.fused_dim, cfg.fusion_heads
    if d % h:
        raise ValueError(f"fused_dim {d} not divisible by heads {h}")

    out: StateDict = {port: _require(sd, ref)
                      for ref, port in _one_to_one(cfg).items()}
    for i in range(cfg.fusion_layers):
        ref = f"fusion.transformer.layers.{i}.self_attn"
        w_in = _require(sd, f"{ref}.in_proj_weight")            # (3d, d)
        b_in = _require(sd, f"{ref}.in_proj_bias")
        for name, w, b in zip(("query", "key", "value"), w_in.split(d),
                              b_in.split(d)):
            out[f"fusion.layers.{i}.self_attn.{name}.weight"] = w.clone()
            out[f"fusion.layers.{i}.self_attn.{name}.bias"] = b.clone()
    return out, cfg


def state_dict_from_params(params: Mapping[str, torch.Tensor],
                           cfg: ModelConfig) -> StateDict:
    """The port's fusion state dict → reference-named float32 tensors
    (``strict=True``-loadable into the reference v2 model)."""
    sd: StateDict = {ref: _t(params[port])
                     for ref, port in _one_to_one(cfg).items()}
    for i in range(cfg.fusion_layers):
        pre = f"fusion.layers.{i}.self_attn"
        ref = f"fusion.transformer.layers.{i}.self_attn"
        sd[f"{ref}.in_proj_weight"] = torch.cat(
            [_t(params[f"{pre}.{k}.weight"]) for k in ("query", "key", "value")])
        sd[f"{ref}.in_proj_bias"] = torch.cat(
            [_t(params[f"{pre}.{k}.bias"]) for k in ("query", "key", "value")])
    return sd


def read_state_dict(path: str) -> Dict[str, Any]:
    """A ``.pth`` state dict: bare, or wrapped under ``state_dict`` /
    ``model_state_dict`` (common torch checkpoint shapes)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model_state_dict"):
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            return obj[key]
    return obj


def load_pth(path: str, cfg: Optional[ModelConfig] = None, *,
             heads: Optional[int] = None,
             **overrides) -> Tuple[StateDict, ModelConfig]:
    """Load a reference ``.pth`` and convert it (see
    :func:`params_from_state_dict`)."""
    return params_from_state_dict(read_state_dict(path), cfg, heads=heads,
                                  **overrides)


def save_pth(path: str, params: Mapping[str, torch.Tensor],
             cfg: ModelConfig) -> None:
    """Write the port's fusion state dict as a reference-loadable ``.pth``."""
    torch.save(state_dict_from_params(params, cfg), path)


def config_from_tree(tree: Mapping[str, Any],
                     heads: Optional[int] = None) -> ModelConfig:
    """The config a flax fusion params tree's shapes imply (``heads``, which
    the shapes do not fix, defaults to 8)."""
    p = tree.get("params", tree)
    fusion, cls = p["fusion"], p["classifier"]
    return ModelConfig(
        video_dim=int(fusion["video_proj"]["kernel"].shape[0]),
        audio_dim=int(fusion["audio_proj"]["kernel"].shape[0]),
        fused_dim=int(fusion["video_proj"]["kernel"].shape[1]),
        num_classes=int(cls["out"]["kernel"].shape[1]),
        max_seq_len=int(fusion["pos_embed"].shape[1]),
        fusion_layers=sum(1 for k in fusion if k.startswith("layer_")),
        fusion_ffn_dim=int(fusion["layer_0"]["ffn_in"]["kernel"].shape[1]),
        classifier_hidden_dim=int(cls["hidden_0"]["kernel"].shape[1]),
        **({"fusion_heads": heads} if heads else {}))


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Checkpoint converter CLI, ``mmer_tpu.models.port_fusion``'s:

    python3 -m mmer_tpu_torch.models.port_fusion ref.pth out.msgpack [--heads 8]
    python3 -m mmer_tpu_torch.models.port_fusion ours.msgpack out.pth

    ``.pth`` → ``.msgpack`` infers the config from the weights; ``.msgpack``
    → ``.pth`` reads it from the tree's shapes."""
    from mmer_tpu_torch.models.convert import fusion_from_flax, fusion_to_flax
    from mmer_tpu_torch.train.checkpoint import (load_params_msgpack,
                                                 save_params_msgpack)

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("src")
    parser.add_argument("dst")
    parser.add_argument("--heads", type=int, default=None,
                        help="fusion head count (not weight-determined; "
                             "default 8, train2.py:252)")
    args = parser.parse_args(argv)

    if args.src.endswith(".pth"):
        sd, cfg = load_pth(args.src, heads=args.heads)
        save_params_msgpack(args.dst, fusion_to_flax(sd, cfg.fusion_heads))
        print(f"{args.src} → {args.dst}  (inferred config: {cfg})")
    else:
        tree = load_params_msgpack(args.src)
        cfg = config_from_tree(tree, args.heads)
        save_pth(args.dst, fusion_from_flax(tree), cfg)
        print(f"{args.src} → {args.dst}  (config from tree: {cfg})")


if __name__ == "__main__":
    main()
