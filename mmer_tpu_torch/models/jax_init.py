"""The JAX package's seeded parameters, drawn in PyTorch without jax or flax.

The JAX package's ViViT and Wav2Vec2 are seeded flax inits that serve as a
fixed random projection (``init_vivit_params``, ``AudioEmbedder._seeded_params``),
and its trainer seeds the fusion model with ``PRNGKey(seed)`` → ``split`` →
``model.init``.  This module redraws those trees on any torch device:

- **threefry2x32, keys and bits** from ``ops/prng.py`` (``jax.random`` as
  jax 0.9 computes it with ``jax_threefry_partitionable`` on): an element's
  bits are the threefry of its key and its flat index, so a leaf can be
  drawn at any set of flat indices without the rest (:func:`draw_tree`); on
  a CUDA device the threefry kernel draws them.
- **flax's key per param** (``flax.core.scope``): a param of the module at
  path ``(m1, ..., mk)``, created as that scope's n-th ``make_rng("params")``
  call, takes ``fold_in(root, h)``, where ``h`` is the first four bytes,
  big-endian, of the SHA-1 of the parts ``m1 ... mk n`` (strings as UTF-8,
  ints as their shortest big-endian bytes; flax 0.12's default has no
  separator between the parts).  Every ``self.param`` call counts, zeros and
  ones included.
- **The initializers** the three models use, in the float32 arithmetic of
  XLA's CPU backend, op for op: uniforms from the top 23 bits; ``erf_inv`` as
  Giles' single-precision polynomial over ``-log1p(-x*x)``, with XLA's own
  Cephes ``log1p`` and ``log`` and its multiply-adds contracted (one
  rounding, done in float64); ``normal`` as ``sqrt(2)*erf_inv`` of a uniform
  on ``(-1, 1)``; ``truncated_normal(-2, 2)`` with the fused ``u*(b-a)+a``
  and the clip inside ``(-2, 2)``; ``lecun_normal``
  (``variance_scaling(1, "fan_in", "truncated_normal")``) over flax's fans:
  ``Dense`` and ``DenseGeneral`` flattened to ``(prod in, prod out)``,
  ``Conv`` ``k * C_in / groups``.

Every step is an IEEE add, multiply, divide or square root, so the CPU and
CUDA give the same bits.  Keys, bits, uniforms and truncated normals come
out bit-equal to jax 0.9 on the CPU; of the normals, those past
``|u| > 0.9933`` (the polynomial's ``w >= 5`` branch, ~0.7 % of draws) are
within 2 ulp, most of them bit-equal (tests/test_torch_jax_weights.py).  The
trees are nested dicts shaped as the JAX models' params, which
``models/convert.py`` maps into the port's state dicts.
"""

from __future__ import annotations

import hashlib
import math
import os
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

# Keys, bits and XLA's float32 math live in ops/prng.py (jax.random for the
# trainers too); re-exported here under the names this module has used.
from mmer_tpu_torch.ops.prng import (  # noqa: F401
    FIX_RNG_SEPARATOR, Key, PRNGKey, _f32, _fma, _SQRT2, _unit_uniform,
    erf_inv, fold_in, fold_in_static, normal, random_bits, split)

# XLA's float32 erf at -2/sqrt(2) and 2/sqrt(2): the truncated normal's bounds.
TRUNC_LOWER_BITS, TRUNC_UPPER_BITS = 0xBF745A18, 0x3F745A18
# flax's truncated-normal variance scaling divides by the stddev of a unit
# normal truncated to [-2, 2].
TRUNC_STD = 0.87962566103423978


def truncated_normal(key: Key, index: torch.Tensor) -> torch.Tensor:
    """``jax.random.truncated_normal(key, -2, 2, shape, float32)`` at flat
    ``index``.  XLA fuses the uniform's ``u*(b-a) + a`` into one rounding (the
    bounds are computed there, not constants)."""
    a, b = _f32(TRUNC_LOWER_BITS), _f32(TRUNC_UPPER_BITS)
    span = float(np.float32(b) - np.float32(a))
    u = torch.clamp_min(_fma(_unit_uniform(random_bits(key, index)), span, a), a)
    out = _SQRT2 * erf_inv(u)
    lo = float(np.nextafter(np.float32(-2.0), np.float32(np.inf)))
    hi = float(np.nextafter(np.float32(2.0), np.float32(-np.inf)))
    return out.clamp(lo, hi)


def lecun_stddev(fan_in: float) -> float:
    """flax ``lecun_normal``'s scale in float32: sqrt(f32(1/fan_in)) / f32(TRUNC_STD)."""
    var = np.float32(1.0 / fan_in)
    return float(np.float32(np.sqrt(var, dtype=np.float32)) / np.float32(TRUNC_STD))


# -- param trees ------------------------------------------------------------------

class Leaf(NamedTuple):
    """One flax param: its initializer (``zeros``, ``ones``, ``normal`` with
    ``scale`` its stddev, ``lecun_normal`` with ``scale`` its fan-in), its
    shape, and its place among its scope's ``make_rng`` calls (from 1)."""
    init: str
    shape: Tuple[int, ...]
    counter: int
    scale: float = 1.0


def draw_leaf(leaf: Leaf, key: Key, index: torch.Tensor,
              jitted: bool = False) -> torch.Tensor:
    """``leaf``'s float32 values at flat ``index`` (int64, on the device to
    draw on), ``key`` being the leaf's own key; ``jitted`` as in
    :func:`normal`."""
    if leaf.init == "zeros":
        return torch.zeros(index.shape, dtype=torch.float32, device=index.device)
    if leaf.init == "ones":
        return torch.ones(index.shape, dtype=torch.float32, device=index.device)
    if leaf.init == "normal":
        return normal(key, index, leaf.scale, jitted)
    if leaf.init == "lecun_normal":
        return truncated_normal(key, index) * lecun_stddev(leaf.scale)
    raise ValueError(f"unknown initializer {leaf.init!r}")


def draw_tree(spec: dict, root: Key, *, device: torch.device | str = "cpu",
              indices: Optional[Callable[[int], np.ndarray]] = None,
              jitted: bool = False, _path: tuple = ()) -> dict:
    """The tree of ``spec`` (nested dicts of :class:`Leaf`) drawn under the
    ``init`` key ``root``: each leaf at its full shape, or with ``indices``
    (leaf size → flat indices) flat at those indices only; ``jitted``: as a
    jitted ``init`` draws (:func:`normal`)."""
    out = {}
    for name, node in spec.items():
        if isinstance(node, Leaf):
            n = math.prod(node.shape)
            if indices is None:
                idx = torch.arange(n, dtype=torch.int64, device=device)
            else:
                idx = torch.as_tensor(np.asarray(indices(n), np.int64),
                                      device=device)
            key = fold_in_static(root, _path + (node.counter,))
            vals = draw_leaf(node, key, idx, jitted)
            out[name] = vals.reshape(node.shape) if indices is None else vals
        else:
            out[name] = draw_tree(node, root, device=device, indices=indices,
                                  jitted=jitted, _path=_path + (name,))
    return out


def sample_indices(n: int, k: int) -> np.ndarray:
    """The fixed sampling rule of the checks: every index of a leaf of at most
    ``k`` elements, else its first and last and ``k - 2`` drawn from
    ``np.random.RandomState(k)`` (a stream numpy keeps frozen), unique and
    sorted."""
    if n <= k:
        return np.arange(n, dtype=np.int64)
    drawn = np.random.RandomState(k).randint(0, n, size=k - 2)
    return np.unique(np.concatenate([[0, n - 1], drawn])).astype(np.int64)


def flat_leaves(tree: dict, _prefix: str = "") -> Dict[str, object]:
    """``{"a/b/kernel": leaf}`` of a nested tree, in sorted key order."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat_leaves(v, f"{_prefix}{k}/"))
        else:
            out[f"{_prefix}{k}"] = v
    return out


# -- the three models' specs --------------------------------------------------------

def _dense(d_in: int, d_out: int, bias: bool = True, in_shape=None,
           out_shape=None) -> dict:
    """flax ``Dense`` (kernel then bias), or ``DenseGeneral`` with the kernel
    shaped ``in_shape + out_shape``: lecun_normal over the flat (in, out)."""
    shape = tuple(in_shape or (d_in,)) + tuple(out_shape or (d_out,))
    spec = {"kernel": Leaf("lecun_normal", shape, 1, float(d_in))}
    if bias:
        spec["bias"] = Leaf("zeros", tuple(out_shape or (d_out,)), 2)
    return spec


def _norm(d: int) -> dict:
    return {"scale": Leaf("ones", (d,), 1), "bias": Leaf("zeros", (d,), 2)}


def _conv(k: int, c_in: int, c_out: int, groups: int = 1) -> dict:
    """flax ``Conv``: kernel (k, C_in / groups, C_out), fan-in k * C_in / groups."""
    cg = c_in // groups
    return {"kernel": Leaf("lecun_normal", (k, cg, c_out), 1, float(k * cg)),
            "bias": Leaf("zeros", (c_out,), 2)}


def vivit_spec(cfg) -> dict:
    """``mmer_tpu.models.vivit.ViViTFeatureExtractor``'s params."""
    ph, pw = cfg.patch_size
    d, inner = cfg.dim, cfg.heads * cfg.dim_head
    tokens = ((cfg.num_frames // cfg.tubelet_size) * (cfg.image_size[0] // ph)
              * (cfg.image_size[1] // pw) + (1 if cfg.pool == "cls" else 0))
    spec: dict = {"embed": {"proj": _dense(cfg.tubelet_size * ph * pw
                                           * cfg.in_channels, d)}}
    counter = 1
    if cfg.pool == "cls":
        spec["cls_token"] = Leaf("normal", (1, 1, d), counter, 1.0)
        counter += 1
    spec["pos_embed"] = Leaf("normal", (1, tokens, d), counter, 1.0)
    for i in range(cfg.depth):
        spec[f"block_{i}"] = {
            "norm1": _norm(d), "to_qkv": _dense(d, 3 * inner, bias=False),
            "to_out": _dense(inner, d, bias=False), "norm2": _norm(d),
            "ffn_in": _dense(d, cfg.mlp_dim), "ffn_out": _dense(cfg.mlp_dim, d)}
    return spec


def wav2vec2_spec(cfg) -> dict:
    """``mmer_tpu.models.wav2vec2.Wav2Vec2Encoder``'s params."""
    enc, c_in = {}, 1
    for i, (dim, k) in enumerate(zip(cfg.conv_dims, cfg.conv_kernels)):
        enc[f"conv_{i}"] = _conv(k, c_in, dim)
        if cfg.feat_extract_norm == "layer":
            enc[f"conv_ln_{i}"] = _norm(dim)
        c_in = dim
    d, h = cfg.hidden_dim, cfg.num_heads
    spec = {"feature_encoder": enc, "proj_norm": _norm(c_in),
            "proj": _dense(c_in, d),
            "pos_conv": {"conv": _conv(cfg.num_conv_pos_embeddings, d, d,
                                       cfg.num_conv_pos_embedding_groups)},
            "final_norm": _norm(d)}
    for i in range(cfg.num_layers):
        heads = _dense(d, d, out_shape=(h, d // h))
        spec[f"layer_{i}"] = {
            "norm_attn": _norm(d), "q": heads, "k": heads, "v": heads,
            "out": _dense(d, d, in_shape=(h, d // h)), "norm_ffn": _norm(d),
            "ffn_in": _dense(d, cfg.ffn_dim), "ffn_out": _dense(cfg.ffn_dim, d)}
    return spec


def fusion_spec(cfg, video_dim: int, audio_dim: int) -> Tuple[dict, dict]:
    """``mmer_tpu.models.fusion.MultimodalEmotionModel``'s (params,
    batch_stats) for video and audio features of those widths."""
    stats: dict = {}

    def token_norm(part: str, name: str, d: int) -> dict:
        if cfg.norm == "layernorm":
            return {"LayerNorm_0": _norm(d)}
        if cfg.norm == "batchnorm":
            stats.setdefault(part, {})[name] = {"BatchNorm_0": {
                "mean": Leaf("zeros", (d,), 0), "var": Leaf("ones", (d,), 0)}}
            return {"BatchNorm_0": _norm(d)}
        if cfg.norm == "none":
            return {}
        raise ValueError(f"unknown norm kind {cfg.norm}")

    f, h = cfg.fused_dim, cfg.fusion_heads
    fusion: dict = {"video_proj": _dense(video_dim, f),
                    "norm_video": token_norm("fusion", "norm_video", f),
                    "audio_proj": _dense(audio_dim, f),
                    "norm_audio": token_norm("fusion", "norm_audio", f),
                    "pos_embed": Leaf("normal", (1, cfg.max_seq_len, f), 1, 0.02)}
    for i in range(cfg.fusion_layers):
        heads = _dense(f, f, out_shape=(h, f // h))
        fusion[f"layer_{i}"] = {
            "self_attn": {"query": heads, "key": heads, "value": heads,
                          "out": _dense(f, f, in_shape=(h, f // h))},
            "norm1": _norm(f), "ffn_in": _dense(f, cfg.fusion_ffn_dim),
            "ffn_out": _dense(cfg.fusion_ffn_dim, f), "norm2": _norm(f)}
    fusion["out_norm"] = token_norm("fusion", "out_norm", f)
    hidden = cfg.classifier_hidden_dim or f // 2
    classifier: dict = {"out": _dense(hidden, cfg.num_classes)}
    d_in = f
    for i in range(2):
        classifier[f"hidden_{i}"] = _dense(d_in, hidden)
        classifier[f"norm_{i}"] = token_norm("classifier", f"norm_{i}", hidden)
        d_in = hidden
    return {"fusion": fusion, "classifier": classifier}, stats


def vivit_tree(cfg, *, device: torch.device | str = "cpu") -> dict:
    """``init_vivit_params(cfg)``'s ``{"params": ...}`` as float32 tensors on
    ``device``."""
    return {"params": draw_tree(vivit_spec(cfg), PRNGKey(cfg.param_seed),
                                device=device, jitted=True)}


def wav2vec2_tree(cfg, *, device: torch.device | str = "cpu") -> dict:
    """``AudioEmbedder(cfg)._seeded_params()``'s ``{"params": ...}`` as
    float32 tensors on ``device``."""
    return {"params": draw_tree(wav2vec2_spec(cfg), PRNGKey(cfg.param_seed),
                                device=device)}


def fusion_key(seed: int) -> Key:
    """The init key of the JAX trainer's model for ``seed``: the second key
    of ``split(PRNGKey(seed))`` (``train/loop.py``, ``train/fused.py``)."""
    return split(PRNGKey(seed))[1]


def fusion_tree(cfg, seed: int, sample_shapes=None, *,
                device: torch.device | str = "cpu",
                key: Optional[Key] = None, jitted: bool = False) -> dict:
    """The JAX trainer's initial fusion variables for ``seed``:
    ``{"params": ...}``, plus ``"batch_stats"`` for a batchnorm model.
    ``sample_shapes`` are the shapes of the init's sample video and audio
    features (only their last axes shape the params; default
    ``cfg.video_dim`` and ``cfg.audio_dim``); ``key`` replaces the trainer's
    derivation (the JAX engine's seeded head uses ``PRNGKey(0)`` itself).
    ``jitted``: as a jitted ``init`` draws ``pos_embed`` (``train_many_seeds``
    and the engine; ``train_model`` inits eagerly), see :func:`normal`."""
    video_dim, audio_dim = ((cfg.video_dim, cfg.audio_dim) if sample_shapes is None
                            else (sample_shapes[0][-1], sample_shapes[1][-1]))
    params, stats = fusion_spec(cfg, video_dim, audio_dim)
    root = fusion_key(seed) if key is None else key
    out = {"params": draw_tree(params, root, device=device, jitted=jitted)}
    if stats:
        out["batch_stats"] = draw_tree(stats, root, device=device)
    return out


# -- the committed reference of the JAX package's weights and features -----------

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "assets", "jax_reference.npz")
FIXTURE_SAMPLES = 64            # sampled indices a leaf (sample_indices)
FIXTURE_SEED = 0


def reference_inputs(seed: int = FIXTURE_SEED):
    """The fixture's inputs, from ``np.random.RandomState(seed)`` (whose
    stream numpy keeps frozen): two uint8 ViViT chunks (2, 32, 224, 224, 3)
    and 16 kHz waveforms of 3.2 s, 12 s (split at 10 s) and 0.5 s."""
    rs = np.random.RandomState(seed)
    chunks = rs.randint(0, 256, size=(2, 32, 224, 224, 3)).astype(np.uint8)
    waves = [(rs.standard_normal(int(s * 16000)) * 0.1).astype(np.float32)
             for s in (3.2, 12.0, 0.5)]
    return chunks, waves


def inputs_digest(chunks: np.ndarray, waves: Sequence[np.ndarray]) -> str:
    """SHA-1 of the inputs' bytes: the fixture records it, so a reader knows
    it rebuilt the same inputs."""
    m = hashlib.sha1(np.ascontiguousarray(chunks).tobytes())
    for w in waves:
        m.update(np.ascontiguousarray(w).tobytes())
    return m.hexdigest()
