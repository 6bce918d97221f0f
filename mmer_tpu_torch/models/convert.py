"""JAX parameter trees → the port's state dicts, and back
(:func:`vivit_to_flax`, :func:`wav2vec2_to_flax`, :func:`fusion_to_flax`, for
writing flax ``.msgpack`` files the JAX package reads).

Each ``*_from_flax`` function takes the flax params of one model as a nested
dict of numpy arrays or torch tensors (with or without the outer
``{"params": ...}``) and returns a state dict for the port's module; torch
tensors stay on their device (``models/jax_init.py`` draws them there).
Layouts: flax ``Dense`` kernels are (in, out) and ``nn.Linear`` weights
(out, in); ``DenseGeneral`` q/k/v kernels are (d, heads, head_dim) and out
kernels (heads, head_dim, d); flax conv kernels are (k, in/groups, out) and
``nn.Conv1d`` weights (out, in/groups, k).

The converters need numpy and torch only, not JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.float()
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _params(tree: Mapping) -> Mapping:
    return tree["params"] if "params" in tree else tree


def _dense(tree: Mapping) -> StateDict:
    out = {"weight": _t(tree["kernel"]).t().contiguous()}
    if "bias" in tree:
        out["bias"] = _t(tree["bias"])
    return out


def _dense_general(tree: Mapping) -> StateDict:
    """(d, h, hd) or (h, hd, d) kernel → a (d_out, d_in) Linear weight."""
    k = _t(tree["kernel"])
    if np.ndim(tree["bias"]) == 2:        # q/k/v: kernel (d, h, hd)
        w = k.reshape(k.shape[0], -1)
    else:                                 # out: kernel (h, hd, d)
        w = k.reshape(-1, k.shape[-1])
    return {"weight": w.t().contiguous(), "bias": _t(tree["bias"]).reshape(-1)}


def _norm(tree: Mapping) -> StateDict:
    return {"weight": _t(tree["scale"]), "bias": _t(tree["bias"])}


def _conv(tree: Mapping) -> StateDict:
    return {"weight": _t(tree["kernel"]).permute(2, 1, 0).contiguous(),
            "bias": _t(tree["bias"])}


def _put(sd: StateDict, prefix: str, part: StateDict) -> None:
    for k, v in part.items():
        sd[f"{prefix}.{k}"] = v


def vivit_from_flax(tree: Mapping) -> StateDict:
    """``mmer_tpu.models.vivit.ViViTFeatureExtractor`` params →
    ``mmer_tpu_torch.models.vivit.ViViTFeatureExtractor`` state dict."""
    p = _params(tree)
    sd: StateDict = {}
    _put(sd, "embed.proj", _dense(p["embed"]["proj"]))
    if "cls_token" in p:
        sd["cls_token"] = _t(p["cls_token"])
    sd["pos_embed"] = _t(p["pos_embed"])
    i = 0
    while f"block_{i}" in p:
        b = p[f"block_{i}"]
        pre = f"blocks.{i}"
        for name in ("norm1", "norm2"):
            _put(sd, f"{pre}.{name}", _norm(b[name]))
        for name in ("to_qkv", "to_out", "ffn_in", "ffn_out"):
            _put(sd, f"{pre}.{name}", _dense(b[name]))
        i += 1
    return sd


def conv_encoder_from_flax(tree: Mapping) -> StateDict:
    """``ConvFeatureEncoder`` params → the port's ``ConvFeatureEncoder``
    state dict."""
    p = _params(tree)
    sd: StateDict = {}
    i = 0
    while f"conv_{i}" in p:
        _put(sd, f"convs.{i}", _conv(p[f"conv_{i}"]))
        _put(sd, f"norms.{i}", _norm(p[f"conv_ln_{i}"]))
        i += 1
    return sd


def wav2vec2_from_flax(tree: Mapping) -> StateDict:
    """``mmer_tpu.models.wav2vec2.Wav2Vec2Encoder`` params →
    ``mmer_tpu_torch.models.wav2vec2.Wav2Vec2Encoder`` state dict."""
    p = _params(tree)
    sd: StateDict = {}
    _put(sd, "feature_encoder", conv_encoder_from_flax(p["feature_encoder"]))
    _put(sd, "proj_norm", _norm(p["proj_norm"]))
    _put(sd, "proj", _dense(p["proj"]))
    _put(sd, "pos_conv.conv", _conv(p["pos_conv"]["conv"]))
    i = 0
    while f"layer_{i}" in p:
        lay = p[f"layer_{i}"]
        pre = f"layers.{i}"
        for name in ("norm_attn", "norm_ffn"):
            _put(sd, f"{pre}.{name}", _norm(lay[name]))
        for name in ("q", "k", "v", "out"):
            _put(sd, f"{pre}.{name}", _dense_general(lay[name]))
        for name in ("ffn_in", "ffn_out"):
            _put(sd, f"{pre}.{name}", _dense(lay[name]))
        i += 1
    _put(sd, "final_norm", _norm(p["final_norm"]))
    return sd


def _token_norm(sd: StateDict, prefix: str, tree: Mapping,
                stats: Mapping | None) -> None:
    """One ``TokenNorm``: its LayerNorm, or its BatchNorm with the running
    statistics of the matching ``batch_stats`` subtree as buffers."""
    if "LayerNorm_0" in tree:
        _put(sd, f"{prefix}.ln", _norm(tree["LayerNorm_0"]))
    elif "BatchNorm_0" in tree:
        _put(sd, f"{prefix}.bn", _norm(tree["BatchNorm_0"]))
        if stats is None:
            raise ValueError(f"{prefix}: a batchnorm model needs its "
                             "batch_stats tree")
        sd[f"{prefix}.bn.running_mean"] = _t(stats["BatchNorm_0"]["mean"])
        sd[f"{prefix}.bn.running_var"] = _t(stats["BatchNorm_0"]["var"])


def fusion_from_flax(tree: Mapping, batch_stats: Mapping | None = None
                     ) -> StateDict:
    """``mmer_tpu.models.fusion.MultimodalEmotionModel`` params →
    ``mmer_tpu_torch.models.fusion.MultimodalEmotionModel`` state dict.  A
    batchnorm (v1) model also takes its ``batch_stats`` tree (or a
    ``{"params", "batch_stats"}`` tree as the first argument): the running
    means and variances become the port's buffers."""
    if batch_stats is None and "batch_stats" in tree:
        batch_stats = tree["batch_stats"]
    p = _params(tree)
    bs = batch_stats or {}
    sd: StateDict = {}
    f = p["fusion"]
    for name in ("video_proj", "audio_proj"):
        _put(sd, f"fusion.{name}", _dense(f[name]))
    for name in ("norm_video", "norm_audio", "out_norm"):
        _token_norm(sd, f"fusion.{name}", f.get(name, {}),
                    bs.get("fusion", {}).get(name))
    sd["fusion.pos_embed"] = _t(f["pos_embed"])
    i = 0
    while f"layer_{i}" in f:
        lay = f[f"layer_{i}"]
        pre = f"fusion.layers.{i}"
        for name in ("query", "key", "value", "out"):
            _put(sd, f"{pre}.self_attn.{name}",
                 _dense_general(lay["self_attn"][name]))
        for name in ("norm1", "norm2"):
            _put(sd, f"{pre}.{name}", _norm(lay[name]))
        for name in ("ffn_in", "ffn_out"):
            _put(sd, f"{pre}.{name}", _dense(lay[name]))
        i += 1
    c = p["classifier"]
    for i in range(2):
        _put(sd, f"classifier.hidden_{i}", _dense(c[f"hidden_{i}"]))
        _token_norm(sd, f"classifier.norm_{i}", c.get(f"norm_{i}", {}),
                    bs.get("classifier", {}).get(f"norm_{i}"))
    _put(sd, "classifier.out", _dense(c["out"]))
    return sd


def _np(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().cpu().numpy().astype(np.float32))


def _sorted_tree(tree):
    """Keys sorted at every level: the order ``jax.device_get`` gives a
    params tree, and so the order the JAX package's checkpoints are written
    in."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def _dense_to(sd, prefix: str) -> dict:
    out = {"kernel": _np(sd[f"{prefix}.weight"].t())}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _heads_to(sd, prefix: str, num_heads: int, out_proj: bool) -> dict:
    """A ``DenseGeneral`` over heads: q/k/v kernels (d, h, hd) with biases
    (h, hd), or the out kernel (h, hd, d) with its bias (d,)."""
    w, b = sd[f"{prefix}.weight"].t(), sd[f"{prefix}.bias"]
    if out_proj:
        return {"kernel": _np(w.reshape(num_heads, -1, w.shape[1])),
                "bias": _np(b)}
    return {"kernel": _np(w.reshape(w.shape[0], num_heads, -1)),
            "bias": _np(b.reshape(num_heads, -1))}


def _norm_to(sd, prefix: str) -> dict:
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def _conv_to(sd, prefix: str) -> dict:
    return {"kernel": _np(sd[f"{prefix}.weight"].permute(2, 1, 0)),
            "bias": _np(sd[f"{prefix}.bias"])}


def vivit_to_flax(sd: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of :func:`vivit_from_flax`: ``{"params": tree}`` of numpy
    float32 arrays, keys sorted, as ``init_vivit_params`` gives it and the JAX
    extractor writes it."""
    p = {"embed": {"proj": _dense_to(sd, "embed.proj")},
         "pos_embed": _np(sd["pos_embed"])}
    if "cls_token" in sd:
        p["cls_token"] = _np(sd["cls_token"])
    i = 0
    while f"blocks.{i}.norm1.weight" in sd:
        pre = f"blocks.{i}"
        p[f"block_{i}"] = {
            **{n: _norm_to(sd, f"{pre}.{n}") for n in ("norm1", "norm2")},
            **{n: _dense_to(sd, f"{pre}.{n}")
               for n in ("to_qkv", "to_out", "ffn_in", "ffn_out")}}
        i += 1
    return _sorted_tree({"params": p})


def wav2vec2_to_flax(sd: Mapping[str, torch.Tensor], num_heads: int) -> dict:
    """The inverse of :func:`wav2vec2_from_flax`: ``{"params": tree}`` of
    numpy float32 arrays, keys sorted (``num_heads`` shapes the attention
    kernels), as ``AudioEmbedder._seeded_params`` gives it."""
    enc = {}
    i = 0
    while f"feature_encoder.convs.{i}.weight" in sd:
        enc[f"conv_{i}"] = _conv_to(sd, f"feature_encoder.convs.{i}")
        if f"feature_encoder.norms.{i}.weight" in sd:
            enc[f"conv_ln_{i}"] = _norm_to(sd, f"feature_encoder.norms.{i}")
        i += 1
    p = {"feature_encoder": enc, "proj_norm": _norm_to(sd, "proj_norm"),
         "proj": _dense_to(sd, "proj"),
         "pos_conv": {"conv": _conv_to(sd, "pos_conv.conv")},
         "final_norm": _norm_to(sd, "final_norm")}
    i = 0
    while f"layers.{i}.norm_attn.weight" in sd:
        pre = f"layers.{i}"
        p[f"layer_{i}"] = {
            **{n: _norm_to(sd, f"{pre}.{n}") for n in ("norm_attn", "norm_ffn")},
            **{n: _heads_to(sd, f"{pre}.{n}", num_heads, n == "out")
               for n in ("q", "k", "v", "out")},
            **{n: _dense_to(sd, f"{pre}.{n}") for n in ("ffn_in", "ffn_out")}}
        i += 1
    return _sorted_tree({"params": p})


def fusion_to_flax(sd: Mapping[str, torch.Tensor], num_heads: int) -> dict:
    """The inverse of :func:`fusion_from_flax`: a fusion state dict → the
    ``mmer_tpu`` model's params tree of numpy float32 arrays, keys sorted
    (``num_heads`` shapes the attention kernels).  A batchnorm model's
    running statistics make it ``{"params", "batch_stats"}``, as the JAX
    trainer writes such a model."""
    stats: dict = {}

    def token_norm(part, name):
        prefix = f"{part}.{name}"
        if f"{prefix}.ln.weight" in sd:
            return {"LayerNorm_0": _norm_to(sd, f"{prefix}.ln")}
        stats.setdefault(part, {})[name] = {"BatchNorm_0": {
            "mean": _np(sd[f"{prefix}.bn.running_mean"]),
            "var": _np(sd[f"{prefix}.bn.running_var"])}}
        return {"BatchNorm_0": _norm_to(sd, f"{prefix}.bn")}

    fusion = {name: _dense_to(sd, f"fusion.{name}")
              for name in ("video_proj", "audio_proj")}
    for name in ("norm_video", "norm_audio", "out_norm"):
        fusion[name] = token_norm("fusion", name)
    fusion["pos_embed"] = _np(sd["fusion.pos_embed"])
    i = 0
    while f"fusion.layers.{i}.norm1.weight" in sd:
        pre = f"fusion.layers.{i}"
        layer = {"self_attn": {name: _heads_to(sd, f"{pre}.self_attn.{name}",
                                               num_heads, name == "out")
                               for name in ("query", "key", "value", "out")}}
        for name in ("norm1", "norm2"):
            layer[name] = _norm_to(sd, f"{pre}.{name}")
        for name in ("ffn_in", "ffn_out"):
            layer[name] = _dense_to(sd, f"{pre}.{name}")
        fusion[f"layer_{i}"] = layer
        i += 1
    classifier = {"out": _dense_to(sd, "classifier.out")}
    for i in range(2):
        classifier[f"hidden_{i}"] = _dense_to(sd, f"classifier.hidden_{i}")
        classifier[f"norm_{i}"] = token_norm("classifier", f"norm_{i}")
    params = {"fusion": fusion, "classifier": classifier}
    if stats:
        return _sorted_tree({"params": params, "batch_stats": stats})
    return _sorted_tree(params)
