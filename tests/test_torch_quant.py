"""The port's int8 path against the JAX package's, on the CPU.

``ops/quant.py`` (``quantize_weight``, ``qdot``, ``qdot_u8``,
``u8_correction``) bit for bit against ``mmer_tpu/ops/quant.py``; the int8
tables of both models bit for bit against ``quantize_vivit_params`` /
``quantize_w2v2_params`` of the same flax trees (carried by
``models/convert.py``); the two int8 forwards on their plain route against
JAX's on the configs of ``tests/test_quant.py``; the three probes rehearsed
at ``--tiny``.  The CUDA kernel (``csrc/qdot.cu``) is held to the plain
versions by ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 6c.

Bounds on the forwards (rel-L2), against JAX's int8-to-float distances on
the same inputs (``tests/test_quant.py``: 0.94-0.99 % a ViViT row, 1.5 % the
Wav2Vec2 hidden states, 0.71-0.77 % a pooled embedding):

- ViViT, a row: 1e-5.  The forwards take the same rounding points, and the
  two frameworks quantize every activation alike (read: 7.6e-8).
- Wav2Vec2 hidden states: 1e-5, with JAX's ``lax.rsqrt`` pinned to the
  correctly rounded value (read: 1.6e-7).  XLA's CPU ``rsqrt`` is an
  approximation (86 % of results correctly rounded on an x86 CPU);
  one ulp of a LayerNorm scale flipped one int8 rounding of the padded
  clip's q/k/v, and the flip cascades through attention to 2.8e-3 in that
  clip: the bound could only be a measure of that chaos.  The port computes
  the correctly rounded root.
- The pooled Wav2Vec2 embedding, a clip, against JAX unpinned: 7e-4, ten
  times under JAX's 0.71 % (read: 3.2e-4 at most; the mean pool and the
  norm average the cascade away).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmer_tpu.config as jax_config
from mmer_tpu.models.vivit import init_vivit_params
from mmer_tpu.models.vivit_quant import quant_vivit_apply as jax_quant_vivit
from mmer_tpu.models.vivit_quant import quantize_vivit_params as jax_quantize_vivit
from mmer_tpu.models.wav2vec2 import AudioEmbedder as JaxAudioEmbedder
from mmer_tpu.models.wav2vec2 import Wav2Vec2Encoder as JaxWav2Vec2
from mmer_tpu.models.wav2vec2_quant import quant_w2v2_apply as jax_quant_w2v2
from mmer_tpu.models.wav2vec2_quant import quantize_w2v2_params as jax_quantize_w2v2
from mmer_tpu.ops import quant as jax_quant
import mmer_tpu_torch.config as port_config
from mmer_tpu_torch.models.convert import vivit_from_flax, wav2vec2_from_flax
from mmer_tpu_torch.models.vivit import ViViTFeatureExtractor
from mmer_tpu_torch.models.vivit_quant import (quant_vivit_apply,
                                               quantize_vivit_params)
from mmer_tpu_torch.models.wav2vec2 import (Wav2Vec2Encoder,
                                            feat_extract_output_length)
from mmer_tpu_torch.models.wav2vec2_quant import (quant_w2v2_apply,
                                                  quant_w2v2_embed,
                                                  quantize_w2v2_params)
from mmer_tpu_torch.ops import quant
from mmer_tpu_torch.scripts import probe_int8, probe_int8_vivit, probe_int8_w2v2

CPU = torch.device("cpu")
# tests/test_quant.py's configs.
VIVIT_KW = dict(num_frames=8, image_size=(32, 32), depth=2, dim=64, heads=4,
                dim_head=16, mlp_dim=128)
W2V2_KW = dict(hidden_dim=32, num_layers=2, num_heads=2, ffn_dim=64,
               conv_dims=(16, 16), conv_strides=(5, 2), conv_kernels=(10, 3),
               num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
               compute_dtype="float32")
VIVIT_REL_L2 = 1e-5
W2V2_REL_L2 = 1e-5
POOLED_REL_L2 = 7e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _same(port: torch.Tensor, ref) -> bool:
    """Equal values, dtypes and shapes (a (K, N) view of an (N, K) buffer
    compares as the (K, N) array it is)."""
    ref = np.asarray(ref)
    got = port.detach().numpy()
    return got.dtype == ref.dtype and got.shape == ref.shape and \
        np.array_equal(got, ref)


def _rows(rng, m, k):
    """Unit-normal rows; an all-zero row; a row of exact .5 quotients
    (absmax 127: its scale is 1); rows whose quotients lie within a few
    ulps of .5 (``fl((j + 0.5) · xs)`` for a random scale), where a slip in
    the division or the rounding shows."""
    x = (rng.normal(size=(m, k)) * 3).astype(np.float32)
    x[1] = 0
    x[2] = np.arange(k) % 254 - 126.5
    x[2, 0] = 127
    for r in range(3, m):
        amax = np.float32(rng.uniform(0.5, 4.0))
        xs = np.float32(amax / np.float32(127))
        j = rng.integers(-126, 126, size=k)
        x[r] = ((j + 0.5) * xs).astype(np.float32)
        x[r, 0] = amax
    return x


# -- ops/quant.py ---------------------------------------------------------------

def test_quantize_weight_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(192, 40)).astype(np.float32)
    w[:, 3] = 0                                 # a zero column: the 1e-12 floor
    w[:, 5] *= 1e-3
    jq, js = jax_quant.quantize_weight(jnp.asarray(w))
    pq, ps = quant.quantize_weight(torch.from_numpy(w))
    assert _same(pq, jq) and _same(ps, js)
    assert pq.t().is_contiguous()               # the kernel's (N, K) operand


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qdot_bit_equal_to_jax(dtype):
    rng = np.random.default_rng(1)
    x = _rows(rng, 40, 256)
    w = rng.normal(size=(256, 48)).astype(np.float32)
    jq, js = jax_quant.quantize_weight(jnp.asarray(w))
    pq, ps = quant.quantize_weight(torch.from_numpy(w))
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xp = torch.from_numpy(x).to(getattr(torch, dtype))
    want = jax_quant.qdot(xj, jq, js)
    assert _same(quant.qdot(xp, pq, ps), want)
    assert _same(quant.qdot(xp.reshape(4, 10, 256), pq, ps),
                 jax_quant.qdot(xj.reshape(4, 10, 256), jq, js))
    b = rng.normal(size=48).astype(np.float32)
    assert _same(quant.qdot(xp, pq, ps, torch.from_numpy(b)), want + b)
    # The plain route's int8 rows and scales, by the JAX expressions.
    xq, xs = quant.row_quant(xp)
    jxs = jnp.maximum(jnp.max(jnp.abs(xj), axis=-1, keepdims=True),
                      1e-8).astype(jnp.float32) / 127.0
    assert _same(xs, jxs)
    assert _same(xq, jnp.round(xj.astype(jnp.float32) / jxs).astype(jnp.int8))
    assert int((xq == 0).all(dim=1).sum()) >= 1 and int(xq[2, 0]) == 127


def test_qdot_u8_and_correction_equal_to_jax():
    rng = np.random.default_rng(2)
    x = rng.integers(0, 256, size=(3, 30, 192), dtype=np.uint8)
    x[0, 0, :4] = [0, 127, 128, 255]
    w = rng.normal(size=(192, 24)).astype(np.float32)
    jq, js = jax_quant.quantize_weight(jnp.asarray(w))
    pq, ps = quant.quantize_weight(torch.from_numpy(w))
    jc, pc = jax_quant.u8_correction(jq), quant.u8_correction(pq)
    assert _same(pc, jc)
    want = jax_quant.qdot_u8(jnp.asarray(x), jq, js, jc)
    assert _same(quant.qdot_u8(torch.from_numpy(x), pq, ps, pc), want)
    b = rng.normal(size=24).astype(np.float32)
    assert _same(quant.qdot_u8(torch.from_numpy(x), pq, ps, pc,
                               bias=torch.from_numpy(b)), want + b)


def test_qdot_limits():
    assert quant.qdot_limits(768, 2304) is None
    assert quant.qdot_limits(4096, 1024) is None
    assert "multiple of 64" in quant.qdot_limits(96, 64)
    assert "multiple of 8" in quant.qdot_limits(64, 12)
    assert "K <=" in quant.qdot_limits(2 * quant.K_MAX, 64)



def _int8_tables(tree, out):
    """The (K, N) shapes of a tree's int8 weight tables."""
    items = tree.values() if isinstance(tree, dict) else tree
    for v in items:
        if isinstance(v, (dict, list)):
            _int8_tables(v, out)
        elif v.dtype == torch.int8:
            out.append(tuple(v.shape))
    return out


def test_qdot_limits_admit_the_forwards_and_the_probe_shapes():
    """Every GEMM of the two int8 forwards at the default widths (their
    tables built on the meta device: a layer each, shapes only) and every
    shape of ``probe_int8`` (JAX's six, ``scripts/probe_int8.py:95-103``)
    pass ``qdot_limits``; a shape the kernel refuses is refused with its
    limit named."""
    vivit = ViViTFeatureExtractor(port_config.ViViTConfig(depth=1), device="meta",
                                  use_kernels=False)
    w2v2 = Wav2Vec2Encoder(port_config.Wav2Vec2Config(num_layers=1), device="meta",
                           use_kernels=False)
    shapes = (_int8_tables(quantize_vivit_params(vivit), [])
              + _int8_tables(quantize_w2v2_params(w2v2), []))
    assert len(shapes) == 10 and (3072, 768) in shapes and (512, 1024) in shapes
    shapes += [(k, n) for _, _, k, n in probe_int8.SHAPES]
    for k, n in shapes:
        assert quant.qdot_limits(k, n) is None, (k, n)
    for (k, n), limit in (((96, 64), "K a multiple of 64"),
                          ((64, 12), "N a multiple of 8"),
                          ((2 * quant.K_MAX, 64), "K <= 65536")):
        assert limit in quant.qdot_limits(k, n)


# -- the int8 tables ------------------------------------------------------------

@pytest.fixture(scope="module")
def vivit_models():
    cfg = jax_config.ViViTConfig(**VIVIT_KW)
    model, params = init_vivit_params(cfg, use_flash=False)
    port = ViViTFeatureExtractor(port_config.ViViTConfig(**VIVIT_KW),
                                 device=CPU, use_kernels=False)
    port.load_state_dict(vivit_from_flax(_np_tree(params)))
    return cfg, model, params, port


@pytest.fixture(scope="module")
def w2v2_models():
    cfg = jax_config.Wav2Vec2Config(**W2V2_KW)
    rng = np.random.default_rng(11)
    wave = rng.normal(size=(3, 3200)).astype(np.float32)
    model = JaxWav2Vec2(cfg)
    params = model.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(wave))
    port = Wav2Vec2Encoder(port_config.Wav2Vec2Config(**W2V2_KW), device=CPU,
                           use_kernels=False)
    port.load_state_dict(wav2vec2_from_flax(_np_tree(params)))
    return cfg, model, params, port, wave


def _tables_equal(port, ref, path=""):
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref), path
        for k in ref:
            _tables_equal(port[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert len(port) == len(ref), path
        for i, (p, r) in enumerate(zip(port, ref)):
            _tables_equal(p, r, f"{path}/{i}")
    else:
        assert _same(port, ref), path


def test_vivit_tables_bit_equal_to_jax(vivit_models):
    _, _, params, port = vivit_models
    _tables_equal(quantize_vivit_params(port), jax_quantize_vivit(params))


def test_w2v2_tables_bit_equal_to_jax(w2v2_models):
    _, _, params, port, _ = w2v2_models
    _tables_equal(quantize_w2v2_params(port), jax_quantize_w2v2(params))


# -- the forwards ---------------------------------------------------------------

def _rel_rows(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return (np.linalg.norm(got - want, axis=-1)
            / np.linalg.norm(want, axis=-1))


def test_quant_vivit_matches_jax(vivit_models):
    cfg, _, params, port = vivit_models
    rng = np.random.default_rng(0)
    x_u8 = (rng.random((2, 8, 32, 32, 3)) * 255).astype(np.uint8)
    want = jax_quant_vivit(jax_quantize_vivit(params), jnp.asarray(x_u8), cfg,
                           use_flash=False)
    qp = quantize_vivit_params(port)
    pcfg = port_config.ViViTConfig(**VIVIT_KW)
    with torch.inference_mode():
        got = quant_vivit_apply(qp, torch.from_numpy(x_u8), pcfg,
                                use_kernels=False)
        # On CPU tensors the kernel route runs the same plain versions.
        assert torch.equal(got, quant_vivit_apply(qp, torch.from_numpy(x_u8),
                                                  pcfg))
    assert got.shape == (2, 64) and got.dtype == torch.float32
    rel = _rel_rows(got, want)
    assert np.all(rel < VIVIT_REL_L2), rel


@pytest.fixture
def rsqrt_rounded(monkeypatch):
    """JAX's ``lax.rsqrt`` as the correctly rounded float32 of 1/sqrt (the
    value the port computes), in place of XLA's CPU approximation."""
    def rsqrt(v):
        return jax.pure_callback(
            lambda a: (1.0 / np.sqrt(np.asarray(a, np.float64))).astype(np.float32),
            jax.ShapeDtypeStruct(v.shape, v.dtype), v)

    monkeypatch.setattr(jax.lax, "rsqrt", rsqrt)


def test_quant_w2v2_matches_jax_on_a_padded_clip(w2v2_models, rsqrt_rounded):
    cfg, _, params, port, wave = w2v2_models
    t = feat_extract_output_length(cfg, wave.shape[1])
    pad = np.zeros((3, t), bool)
    pad[2, t // 2:] = True
    want = np.asarray(jax_quant_w2v2(jax_quantize_w2v2(params), params,
                                     jnp.asarray(wave), jnp.asarray(pad), cfg))
    with torch.inference_mode():
        got = quant_w2v2_apply(quantize_w2v2_params(port), port,
                               torch.from_numpy(wave), torch.from_numpy(pad),
                               use_kernels=False).numpy()
    assert got.shape == want.shape and np.all(np.isfinite(got))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < W2V2_REL_L2, rel


def test_quant_w2v2_pooled_embedding_matches_jax():
    """The embedder's preprocessing, then the int8 forward with the masked
    mean pool and L2 norm, against JAX's (``tests/test_quant.py``'s
    comparison), with XLA's own rsqrt."""
    cfg = jax_config.Wav2Vec2Config(**W2V2_KW)
    emb = JaxAudioEmbedder(cfg, use_pallas=False)
    rng = np.random.default_rng(12)
    stack = np.stack([rng.normal(size=(3200,)).astype(np.float32)
                      for _ in range(3)])
    norm = ((stack - stack.mean(1, keepdims=True))
            / np.sqrt(stack.var(1) + 1e-7)[:, None]).astype(np.float32)
    t = feat_extract_output_length(cfg, 3200)
    pad = np.zeros((3, t), bool)
    hidden = np.asarray(jax_quant_w2v2(jax_quantize_w2v2(emb.params), emb.params,
                                       jnp.asarray(norm), jnp.asarray(pad), cfg))
    e = hidden.mean(axis=1)
    want = e / np.linalg.norm(e, axis=1, keepdims=True)

    port = Wav2Vec2Encoder(port_config.Wav2Vec2Config(**W2V2_KW), device=CPU,
                           use_kernels=False)
    port.load_state_dict(wav2vec2_from_flax(_np_tree(emb.params)))
    with torch.inference_mode():
        got = quant_w2v2_embed(quantize_w2v2_params(port), port,
                               torch.from_numpy(norm), torch.from_numpy(pad),
                               use_kernels=False)
    rel = _rel_rows(got, want)
    assert np.all(rel < POOLED_REL_L2), rel


# -- the probes -------------------------------------------------------------------

def test_probe_int8_tiny():
    rows = probe_int8.main(["--tiny"])
    legs = {r["leg"] for r in rows}
    assert legs == {"bf16", "int8_kernel", "int8_dynamic", "int_mm"}
    assert len(rows) == 4 * len(probe_int8.SHAPES)
    for r in rows:
        assert r["ms"] > 0 and r["device"] == "cpu"


def test_probe_int8_vivit_tiny():
    rows = {r["name"]: r for r in probe_int8_vivit.main(["--tiny"])}
    assert set(rows) == {"bf16", "int8-flash", "int8-plain-attn"}
    for name in ("int8-flash", "int8-plain-attn"):
        r = rows[name]
        assert r["cos_min"] > 0.999 and r["rel_l2_mean"] < 0.05
        assert r["plain_route_rel_l2"] < 1e-6
        assert r["ms"] > 0 and r["speedup"] > 0


def test_probe_int8_w2v2_tiny():
    rows = {r["name"]: r for r in probe_int8_w2v2.main(["--tiny"])}
    assert set(rows) == {"bf16", "int8"}
    r = rows["int8"]
    assert r["cos_min"] > 0.999 and r["plain_route_rel_l2"] < 1e-6
    assert r["ms"] > 0 and r["clips_per_s"] > 0


@pytest.mark.parametrize("script", [probe_int8, probe_int8_vivit,
                                    probe_int8_w2v2])
def test_probes_refuse_to_start_without_cuda(script, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        script.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        script.main(["--device", "cuda", "--tiny"])


@pytest.mark.parametrize("module", [quant, probe_int8, probe_int8_vivit,
                                    probe_int8_w2v2])
def test_the_slice_imports_neither_jax_nor_the_jax_package(module):
    import ast
    import importlib

    names = ["mmer_tpu_torch.models.vivit_quant",
             "mmer_tpu_torch.models.wav2vec2_quant", module.__name__]
    for name in names:
        tree = ast.parse(open(importlib.import_module(name).__file__).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not {"jax", "flax", "mmer_tpu"} & set(roots), (name, roots)
