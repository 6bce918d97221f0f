"""The PyTorch port's kernel functions against the JAX package's.

Each of the three functions that carries a CUDA kernel in
``mmer_tpu_torch.ops`` is run on the CPU, where it takes its plain PyTorch
version, and compared with the JAX function run as the JAX package's own
tests run it: the Pallas kernel in interpret mode, and the plain XLA path.
Inputs come from ``np.random.default_rng``; both sides get the same numpy
arrays.  In float32 the tolerances only cover summation order; the bf16
cases pin the rounding points, each with a bound that a misplaced rounding
point exceeds.

The kernels themselves are checked on a GPU by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as fnn
from mmer_tpu.config import Wav2Vec2Config as JaxWav2Vec2Config
from mmer_tpu.models.wav2vec2 import ConvFeatureEncoder as JaxConvEncoder
from mmer_tpu.ops import conv_pyramid as jax_conv
from mmer_tpu.ops import flash_attention as jax_attn
from mmer_tpu.ops import fused_blocks as jax_blocks
from mmer_tpu_torch.config import Wav2Vec2Config
from mmer_tpu_torch.models.convert import conv_encoder_from_flax
from mmer_tpu_torch.ops.conv_pyramid import (fused_conv_encoder, gemm_weight,
                                             supports_config)
from mmer_tpu_torch.ops.flash_attention import flash_attention
from mmer_tpu_torch.ops.fused_blocks import fused_ffn, layer_norm
from mmer_tpu_torch.ops.masked_ops import (attention_bias_from_pad_mask,
                                           masked_mean_pool)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# -- fused FFN ---------------------------------------------------------------

def _ffn_inputs(seed, b, s, d, m):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(x=rng.normal(size=(b, s, d)).astype(f),
                scale=(rng.normal(size=(d,)) * 0.1 + 1.0).astype(f),
                bias=(rng.normal(size=(d,)) * 0.1).astype(f),
                w1=(rng.normal(size=(d, m)) * 0.05).astype(f),
                b1=(rng.normal(size=(m,)) * 0.1).astype(f),
                w2=(rng.normal(size=(m, d)) * 0.05).astype(f),
                b2=(rng.normal(size=(d,)) * 0.1).astype(f))


def _port_ffn(p):
    # The port takes nn.Linear layouts: w1 (M, D), w2 (D, M).
    return fused_ffn(_t(p["x"]), _t(p["scale"]), _t(p["bias"]), _t(p["w1"].T),
                     _t(p["b1"]), _t(p["w2"].T), _t(p["b2"])).numpy()


@pytest.mark.parametrize("shape", [(2, 37, 64, 128), (1, 50, 32, 384)])
def test_ffn_matches_pallas_interpret(shape):
    p = _ffn_inputs(1, *shape)
    want = jax_blocks.fused_ffn(*(jnp.asarray(p[k]) for k in
                                  ("x", "scale", "bias", "w1", "b1", "w2", "b2")),
                                interpret=True)
    # f32 throughout: only the order of the GEMM sums differs.
    np.testing.assert_allclose(_port_ffn(p), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


def test_ffn_matches_jax_plain_path():
    p = _ffn_inputs(2, 2, 37, 64, 128)

    class LN(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.LayerNorm(dtype=jnp.float32, name="ln")(x)

    x = jnp.asarray(p["x"])
    y = LN().apply({"params": {"ln": {"scale": p["scale"], "bias": p["bias"]}}},
                   x)
    want = x + fnn.gelu(y @ p["w1"] + p["b1"], approximate=False) @ p["w2"] \
        + p["b2"]
    np.testing.assert_allclose(_port_ffn(p), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


def _bf16_ffn_args(p, caller):
    """JAX and port arguments from one set of inputs, weights in bf16, the
    rest as each caller passes it: ViViT a bf16 stream with f32 biases,
    Wav2Vec2 an f32 stream with bf16 biases."""
    jd = {k: jnp.asarray(v) for k, v in p.items()}
    td = {k: _t(v) for k, v in p.items()}
    for k in ("w1", "w2") + (("x",) if caller == "vivit" else ("b1", "b2")):
        jd[k] = jd[k].astype(jnp.bfloat16)
        td[k] = td[k].bfloat16()
    jargs = [jd[k] for k in ("x", "scale", "bias", "w1", "b1", "w2", "b2")]
    targs = [td["x"], td["scale"], td["bias"], td["w1"].t().contiguous(),
             td["b1"], td["w2"].t().contiguous(), td["b2"]]
    return jargs, targs


@pytest.mark.parametrize("caller", ["vivit", "wav2vec2"])
@pytest.mark.parametrize("shape", [(2, 37, 64, 128), (1, 50, 32, 384)])
def test_ffn_bf16_matches_pallas_interpret(shape, caller):
    jargs, targs = _bf16_ffn_args(_ffn_inputs(1, *shape), caller)
    want = np.asarray(jax_blocks.fused_ffn(*jargs, interpret=True)
                      .astype(jnp.float32))
    got = fused_ffn(*targs)
    assert got.dtype == targs[0].dtype
    diff = np.abs(got.float().numpy() - want)
    # Same rounding points (hidden units rounded to bf16 before W2, the
    # output rounded once): only f32 summation order can flip a bf16
    # rounding, for about one element in 10^3.  A misplaced rounding point
    # reads a mean error of 1.6e-4 or more: hidden units kept in f32,
    # ViViT's f32 biases rounded to bf16, Wav2Vec2's f32 stream rounded.
    assert float(diff.max()) <= 2 ** -7 * float(np.abs(want).max())
    assert float(diff.mean()) <= 1e-5, float(diff.mean())


def test_layer_norm_is_flax_layernorm():
    """eps 1e-6, not torch's 1e-5: at a variance of 1e-4 the two differ by
    ~5%, far outside the tolerance."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(4, 48)) * 0.01).astype(np.float32)
    w, b = rng.normal(size=(2, 48)).astype(np.float32)

    class LN(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.LayerNorm(dtype=jnp.float32, name="ln")(x)

    want = LN().apply({"params": {"ln": {"scale": w, "bias": b}}},
                      jnp.asarray(x))
    got = layer_norm(_t(x), _t(w), _t(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)


# -- attention ---------------------------------------------------------------

@pytest.mark.parametrize("s", [40, 200])
def test_attention_matches_pallas_interpret(s):
    """S not a multiple of 128: the Pallas kernel pads to 128 and masks the
    padded keys; the port's result must equal attention over the true S."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, 3, s, 64)).astype(np.float32)
               for _ in range(3))
    want = jax_attn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), interpret=True)
    got = flash_attention(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    plain = jax_attn.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v))
    np.testing.assert_allclose(got, np.asarray(plain), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("s", [40, 200])
def test_attention_bf16_rounding_points(s):
    """bf16 q, k, v, with q and k doubled so that the scores have a std of
    ~4: rounding them to bf16 would then move p by ~1 %."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, 3, s, 64)).astype(np.float32)
               for _ in range(3))
    q, k = 2 * q, 2 * k
    jq = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    got = flash_attention(*(_t(a).bfloat16() for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()

    # The JAX plain path has the same rounding points (f32 scores and
    # softmax, p rounded to bf16 after normalising): a rare one-ulp flip at
    # most.  Rounded scores read a mean error of 2^-7 of mean |out|, p left
    # in f32 2^-9.5.
    plain = np.asarray(jax_attn.reference_attention(*jq).astype(jnp.float32))
    d = np.abs(got - plain)
    assert d.max() <= 2 ** -8 * np.abs(plain).max()
    assert d.mean() <= 2 ** -14 * np.abs(plain).mean()
    # The Pallas kernel rounds exp(s - max) before normalising, so the two
    # differ by about a third of a bf16 ulp on average.
    pallas = np.asarray(jax_attn.flash_attention(*jq, interpret=True)
                        .astype(jnp.float32))
    d = np.abs(got - pallas)
    assert d.max() <= 2 ** -6 * np.abs(pallas).max()
    assert d.mean() <= 2 ** -8 * np.abs(pallas).mean()


def test_attention_key_lens_not_ported():
    q = torch.zeros(1, 1, 8, 64)
    with pytest.raises(NotImplementedError):
        flash_attention(q, q, q, key_lens=torch.tensor([4]))


# -- conv feature encoder ----------------------------------------------------

def _conv_params(cfg, seed=0):
    import jax
    enc = JaxConvEncoder(cfg)
    return enc.init({"params": jax.random.PRNGKey(seed)},
                    jnp.zeros((1, 1600), jnp.float32))


def _port_conv_args(params, n_layers):
    sd = conv_encoder_from_flax(params)
    return [[sd[f"{kind}.{i}.{name}"] for i in range(n_layers)]
            for kind, name in (("convs", "weight"), ("convs", "bias"),
                               ("norms", "weight"), ("norms", "bias"))]


@pytest.mark.parametrize("length", [1600, 1923])
def test_conv_encoder_matches_pallas_interpret(length):
    """The real 512-wide layer spec at a short waveform, f32: against the
    Pallas mega kernel (interpret mode) and the plain XLA module."""
    jcfg = JaxWav2Vec2Config(compute_dtype="float32")
    cfg = Wav2Vec2Config(compute_dtype="float32")
    rng = np.random.default_rng(0)
    wave = rng.normal(size=(2, length)).astype(np.float32)
    params = _conv_params(jcfg)

    got = fused_conv_encoder(_t(wave), *_port_conv_args(params, 7), cfg).numpy()
    want = jax_conv.fused_conv_encoder(jnp.asarray(wave), params["params"],
                                       jcfg, interpret=True, mega=True)
    assert got.shape == want.shape
    # Same tolerance as tests/test_conv_pyramid.py: seven f32 layers, each
    # a K≤1536 GEMM whose summation order differs.
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-4, rtol=2e-4)
    plain = JaxConvEncoder(jcfg).apply(params, jnp.asarray(wave))
    np.testing.assert_allclose(got, np.asarray(plain), atol=2e-4, rtol=2e-4)


def test_conv_encoder_bf16_rounding_points():
    """bf16: the plain version takes the Pallas kernel's rounding points;
    the remaining differences are f32 summation order flipping a bf16
    rounding (tolerance of tests/test_conv_pyramid.py's bf16 case)."""
    jcfg = JaxWav2Vec2Config(compute_dtype="bfloat16")
    cfg = Wav2Vec2Config(compute_dtype="bfloat16")
    rng = np.random.default_rng(1)
    wave = rng.normal(size=(2, 1600)).astype(np.float32)
    params = _conv_params(jcfg)
    got = fused_conv_encoder(_t(wave), *_port_conv_args(params, 7), cfg)
    assert got.dtype == torch.bfloat16
    want = jax_conv.fused_conv_encoder(jnp.asarray(wave), params["params"],
                                       jcfg, interpret=True, mega=True)
    diff = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    assert float(diff.max()) <= 0.06, float(diff.max())
    assert float(diff.mean()) <= 5e-3, float(diff.mean())


def test_supports_config_matches_jax():
    for kernels, strides, norm in [((10, 3, 3, 3, 3, 2, 2), (5, 2, 2, 2, 2, 2, 2),
                                    "layer"),
                                   ((10, 4), (5, 2), "layer"),
                                   ((10, 3), (5, 3), "layer"),
                                   ((10, 3), (5, 2), "group")]:
        kw = dict(conv_kernels=kernels, conv_strides=strides,
                  conv_dims=(512,) * len(kernels), feat_extract_norm=norm)
        assert supports_config(Wav2Vec2Config(**kw)) == \
            jax_conv.supports_config(JaxWav2Vec2Config(**kw))


def test_gemm_weight_is_tap_major_and_padded():
    w = torch.arange(2 * 3 * 5, dtype=torch.float32).reshape(2, 3, 5)
    g = gemm_weight(w, torch.float32)
    assert g.shape == (2, 16)
    # column j*C_in + c holds tap j of input channel c.
    assert g[1, 4 * 3 + 2] == w[1, 2, 4]
    assert torch.all(g[:, 15:] == 0)


# -- masked ops --------------------------------------------------------------

def test_masked_ops_match_jax():
    from mmer_tpu.ops import masked_ops as jm
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 4, 8)).astype(np.float32)
    mask = np.array([[0, 0, 1, 1], [0, 0, 0, 0], [1, 1, 1, 1]], bool)
    np.testing.assert_allclose(
        masked_mean_pool(_t(x), torch.from_numpy(mask)).numpy(),
        np.asarray(jm.masked_mean_pool(jnp.asarray(x), jnp.asarray(mask))),
        atol=1e-6)
    np.testing.assert_array_equal(
        attention_bias_from_pad_mask(torch.from_numpy(mask)).numpy(),
        np.asarray(jm.attention_bias_from_pad_mask(jnp.asarray(mask))))
