"""The port's one-GEMM q/k/v option and its component probe scripts against
the JAX package's, on the CPU.

``Wav2Vec2Encoder(use_fused_qkv=True)`` is held to JAX's fused encoder on
the same weights (carried by ``models/convert.py``) in float32 and in
bfloat16, and to the port's own three-projection route.  The FLOP counters
of ``profile_conv_pyramid``, ``probe_w2v2_flash`` and ``probe_vivit_b32``
equal the JAX scripts' (imported, not edited) as integers.  Each probe's
``main`` is rehearsed at ``--device cpu --tiny`` (plain versions, host
clock), and every script of the slice refuses to start without CUDA unless
``--device cpu`` is given.  The CUDA routes are held on a card by
``chip_smoke.py`` (phase 6b).
"""

import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmer_tpu.config as jax_config
from mmer_tpu.models.wav2vec2 import AudioEmbedder as JaxAudioEmbedder
from mmer_tpu.models.wav2vec2 import EncoderLayer as JaxEncoderLayer
from mmer_tpu.models.wav2vec2 import Wav2Vec2Encoder as JaxWav2Vec2
import mmer_tpu_torch.config as port_config
from mmer_tpu_torch.models.convert import wav2vec2_from_flax
from mmer_tpu_torch.models.wav2vec2 import (AudioEmbedder, Wav2Vec2Encoder,
                                            feat_extract_output_length)
from mmer_tpu_torch.scripts import (probe_extract_pipeline, probe_vivit_b32,
                                    probe_w2v2_flash, probe_w2v2_qkv,
                                    profile_conv_pyramid, profile_cp_layers,
                                    profile_vivit)

from torch_threads import few_threads  # noqa: F401

# The JAX conv-profile script puts a fixed checkout path first on sys.path
# when it is imported; put sys.path back so that modules collected after this
# one resolve ``scripts`` and ``tests`` in this checkout.
_SAVED_PATH = list(sys.path)
import scripts.probe_vivit_b32 as jax_vivit_b32  # noqa: E402
import scripts.probe_w2v2_flash as jax_w2v2_flash  # noqa: E402
import scripts.profile_conv_pyramid as jax_conv_pyramid  # noqa: E402
_PATH_AFTER_IMPORT = list(sys.path)
sys.path[:] = _SAVED_PATH
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CPU = torch.device("cpu")
# tests/test_wav2vec2.py's tiny config.
W2V2_KW = dict(hidden_dim=32, num_layers=2, num_heads=2, ffn_dim=64,
               conv_dims=(16, 16), conv_strides=(5, 2), conv_kernels=(10, 3),
               num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
               compute_dtype="float32")
BF16 = dict(W2V2_KW, compute_dtype="bfloat16")


def test_jax_script_imports_leave_sys_path_as_found():
    """The JAX scripts are this checkout's, and the path that the conv-profile
    script inserts is gone again once this module is imported."""
    for mod in (jax_vivit_b32, jax_w2v2_flash, jax_conv_pyramid):
        assert os.path.dirname(os.path.abspath(mod.__file__)) == os.path.join(
            ROOT, "scripts")
    n_inserted = len(_PATH_AFTER_IMPORT) - len(_SAVED_PATH)
    assert n_inserted > 0
    assert _PATH_AFTER_IMPORT[n_inserted:] == _SAVED_PATH


@pytest.fixture(scope="module")
def jax_params():
    """JAX's init of the tiny encoder, moved off flax's zero biases and unit
    LayerNorms so that a bias added at the wrong point shows."""
    cfg = jax_config.Wav2Vec2Config(**W2V2_KW)
    params = JaxWav2Vec2(cfg).init({"params": jax.random.PRNGKey(0)},
                                   jnp.zeros((1, 3200), jnp.float32))
    rng = np.random.default_rng(3)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.normal(size=a.shape)
                   ).astype(np.float32), params)


def _wave_and_mask(seed):
    rng = np.random.default_rng(seed)
    wave = rng.normal(size=(2, 3200)).astype(np.float32)
    t = feat_extract_output_length(port_config.Wav2Vec2Config(**W2V2_KW), 3200)
    mask = np.zeros((2, t), bool)
    mask[1, t // 2:] = True
    return wave, mask


def _port(kw, params, **flags):
    model = Wav2Vec2Encoder(port_config.Wav2Vec2Config(**kw), device=CPU,
                            use_kernels=False, **flags)
    model.load_state_dict(wav2vec2_from_flax(params))
    return model.eval()


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("flash", [False, True])
def test_fused_qkv_encoder_matches_jax_f32(jax_params, flash):
    """One (d, 3d) product over the concatenated weights, then either
    attention route, against JAX's ``use_fused_qkv=True`` encoder with a
    padded row.  Plain attention: JAX's own bound for the fused layout
    (tests/test_wav2vec2.py, 1e-5).  Flash: JAX's varlen kernel in interpret
    mode against the port's plain version, the bound of the port's other
    flash-vs-Pallas test (5e-4)."""
    wave, mask = _wave_and_mask(0)
    want = np.asarray(JaxWav2Vec2(jax_config.Wav2Vec2Config(**W2V2_KW),
                                  use_flash_attn=flash, use_fused_qkv=True
                                  ).apply(jax_params, jnp.asarray(wave),
                                          jnp.asarray(mask)))
    port = _port(W2V2_KW, jax_params, use_flash_attn=flash, use_fused_qkv=True)
    assert all(layer.use_fused_qkv for layer in port.layers)
    with torch.inference_mode():
        got = port(torch.from_numpy(wave), torch.from_numpy(mask)).numpy()
    tol = 5e-4 if flash else 1e-5
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_fused_qkv_projection_bf16_matches_jax_formula(jax_params):
    """The fused product itself in bf16 against JAX's lines
    (``mmer_tpu/models/wav2vec2.py``: ``w``, ``b`` concatenated and cast,
    ``yd @ w + b``) on the same bf16 ``yd``: the product rounded to bf16,
    then the bf16 bias added and rounded again.  Summation order may flip a
    product's rounding: at most one bf16 step apart, on under 1 % of the
    elements (rounding once, after an f32 bias add, moves about a tenth)."""
    rng = np.random.default_rng(6)
    yd = rng.normal(size=(2, 20, 32)).astype(np.float32)
    p = jax_params["params"]["layer_0"]
    w = jnp.concatenate([jnp.asarray(p[n]["kernel"]).reshape(32, 32)
                         for n in ("q", "k", "v")], axis=1).astype(jnp.bfloat16)
    b = jnp.concatenate([jnp.asarray(p[n]["bias"]).reshape(32)
                         for n in ("q", "k", "v")]).astype(jnp.bfloat16)
    want = np.asarray((jnp.asarray(yd, jnp.bfloat16) @ w + b).astype(jnp.float32))
    port = Wav2Vec2Encoder(port_config.Wav2Vec2Config(**BF16), device=CPU,
                           use_fused_qkv=True)
    port.load_state_dict(wav2vec2_from_flax(jax_params))
    with torch.inference_mode():
        got = torch.cat(port.layers[0].project_qkv(
            torch.from_numpy(yd).to(torch.bfloat16)), dim=-1)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 20, 96)
    got = got.float().numpy()
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= step)
    assert np.mean(got != want) < 0.01, np.mean(got != want)


def test_fused_qkv_layer_bf16_rounding_points(jax_params):
    """bf16: the product rounded once to bf16, the concatenated bias (bf16)
    added after it, as JAX's ``yd @ w + b``; against the JAX layer on its
    Pallas FFN route (interpret mode), the bound of the port's separate-
    projection bf16 layer test (2e-5)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 20, 32)).astype(np.float32)
    mask = np.zeros((2, 20), bool)
    mask[1, 14:] = True
    want = JaxEncoderLayer(jax_config.Wav2Vec2Config(**BF16), use_fused_ffn=True,
                           use_fused_qkv=True).apply(
        {"params": jax_params["params"]["layer_0"]}, jnp.asarray(x),
        jnp.asarray(mask))
    port = Wav2Vec2Encoder(port_config.Wav2Vec2Config(**BF16), device=CPU,
                           use_fused_qkv=True)
    port.load_state_dict(wav2vec2_from_flax(jax_params))
    with torch.inference_mode():
        got = port.layers[0](torch.from_numpy(x), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    assert _rel_l2(got.numpy(), want) <= 2e-5, _rel_l2(got.numpy(), want)


def test_fused_qkv_embedder_bf16_matches_jax(jax_params):
    """The whole bf16 embedder with ``use_fused_qkv`` against JAX's on its
    Pallas route (interpret mode), the bound of the port's bf16 embedder
    test (2.5e-3: bf16 rounding order spread over the layers)."""
    rng = np.random.default_rng(1)
    waves = [rng.normal(size=(n,)).astype(np.float32) * s
             for n, s in ((4800, 1.0), (12800, 0.3), (900, 2.0))]
    want = JaxAudioEmbedder(jax_config.Wav2Vec2Config(**BF16), params=jax_params,
                            use_pallas=True, use_fused_qkv=True).embed_batch(waves)
    port = AudioEmbedder(port_config.Wav2Vec2Config(**BF16), device=CPU,
                         params=wav2vec2_from_flax(jax_params),
                         use_fused_qkv=True)
    assert all(layer.use_fused_qkv for layer in port.model.layers)
    got = port.embed_batch(waves)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    assert _rel_l2(got, want) <= 2.5e-3, _rel_l2(got, want)


def test_fused_qkv_matches_separate_projections(jax_params):
    """The port's two layouts on the same weights (the params keep the
    three-projection layout: the same state-dict keys), f32, a padded row."""
    wave, mask = _wave_and_mask(5)
    separate = _port(W2V2_KW, jax_params)
    fused = _port(W2V2_KW, jax_params, use_fused_qkv=True)
    assert separate.state_dict().keys() == fused.state_dict().keys()
    assert not any(layer.use_fused_qkv for layer in separate.layers)
    with torch.inference_mode():
        want = separate(torch.from_numpy(wave), torch.from_numpy(mask)).numpy()
        got = fused(torch.from_numpy(wave), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kw", [{}, W2V2_KW], ids=["default", "tiny"])
def test_conv_and_encoder_flops_equal_jax_scripts(kw):
    jcfg, cfg = jax_config.Wav2Vec2Config(**kw), port_config.Wav2Vec2Config(**kw)
    for n in (64000, 80000, 3200):
        want = jax_conv_pyramid.conv_flops(jcfg, n)
        assert profile_conv_pyramid.conv_flops(cfg, n) == want
        assert all(isinstance(v, int) for v in want)
    t = feat_extract_output_length(cfg, jax_w2v2_flash.SAMPLES)
    want = jax_w2v2_flash.model_flops(jcfg, t)
    got = probe_w2v2_flash.model_flops(cfg, t)
    assert isinstance(got, int) and got == want


@pytest.mark.parametrize("b", [16, 32])
def test_vivit_flops_equal_jax_script(b):
    """JAX's counter holds the default ViViT's widths as constants, so it is
    compared at the default config only."""
    got = profile_vivit.model_flops(port_config.ViViTConfig(), b)
    assert isinstance(got, int) and got == jax_vivit_b32.model_flops(b)


def _check_rows(rows, names):
    assert [r["name"] for r in rows] == names
    for r in rows:
        assert r["device"] == "cpu"
        if "ms" in r:
            assert r["ms"] > 0 and r["calls"] >= 1


def test_profile_conv_pyramid_rehearsal():
    rows = profile_conv_pyramid.main(["--device", "cpu", "--tiny"])
    _check_rows(rows, ["conv plain", "conv layers", "conv mega", "full plain",
                       "full kernels"])
    for r in rows[:3]:
        assert r["bound_ms"] > 0 and r["bound_by"] in ("operations", "bytes")
        assert r["max_abs_diff"] <= 1e-4
    assert rows[0]["max_abs_diff"] == 0.0
    assert all(r["clips_per_s"] > 0 for r in rows[3:])


def test_profile_cp_layers_rehearsal():
    rows = profile_cp_layers.main(["--device", "cpu", "--tiny"])
    _check_rows(rows, ["L0 (k10)"] + [f"L{i} (k{k})" for i, k in
                                      enumerate((3, 3, 3, 3, 2, 2), start=1)])
    pads = [r["t_pad"] for r in rows]
    assert pads == [12800, 6400, 3200, 1600, 800, 400, 200]
    assert all(r["bound_ms"] > 0 for r in rows)


@pytest.mark.parametrize("script,names", [
    (probe_w2v2_flash, ["plain-attn", "flash-attn"]),
    (probe_w2v2_qkv, ["separate-qkv", "fused-qkv"])])
def test_encoder_ab_rehearsal(script, names):
    """On the CPU both variants run the plain versions in f32: equal
    outputs."""
    rows = script.main(["--device", "cpu", "--tiny"])
    _check_rows(rows, names)
    assert rows[-1]["max_abs_diff"] <= 1e-5
    assert rows[-1]["clip_rel_l2_max"] <= 1e-5
    assert all(r["clips_per_s"] > 0 for r in rows)


def test_probe_vivit_b32_rehearsal():
    rows = probe_vivit_b32.main(["--device", "cpu", "--tiny"])
    _check_rows(rows, ["B=16", "B=32"])
    assert [r["batch"] for r in rows] == [16, 32]
    assert all(r["chunks_per_s"] > 0 for r in rows)


def test_probe_extract_pipeline_rehearsal_bit_identical():
    """Six blocks of 16 tiny chunks through both loop shapes: the script
    fails unless ``pipeline=True`` gives ``pipeline=False``'s bits."""
    rows = probe_extract_pipeline.main(["--device", "cpu", "--tiny"])
    _check_rows(rows, ["pipeline=False", "pipeline=True", "pipeline speedup"])
    assert rows[-1]["bit_identical"] is True
    assert rows[0]["chunks_per_s"] > 0 and rows[-1]["speedup"] > 0


SCRIPTS = ["profile_conv_pyramid", "profile_cp_layers", "probe_w2v2_flash",
           "probe_w2v2_qkv", "probe_vivit_b32", "probe_extract_pipeline",
           "sweep", "quality_sweep", "probe_recipe_sweep_r4", "probe_ensemble",
           "probe_diverse_ensemble", "probe_mixup_quality",
           "probe_feature_noise_quality", "probe_distill", "demo_frontend"]


@pytest.mark.parametrize("name", SCRIPTS)
def test_scripts_refuse_to_start_without_cuda(name, monkeypatch):
    """The card by default: without CUDA a script raises before it builds
    or loads anything, unless ``--device cpu`` is given."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"mmer_tpu_torch.scripts.{name}")
    with pytest.raises(RuntimeError, match="--device cpu"):
        module.main([])
