"""The PyTorch port's kernel functions against the JAX package's.

Each of the functions that carries a CUDA kernel in
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
from mmer_tpu_torch.ops import conv_pyramid as port_conv
from mmer_tpu_torch.ops.conv_pyramid import (fused_conv_encoder, gemm_weight,
                                             supports_config)
from mmer_tpu_torch.ops.flash_attention import (flash_attention,
                                                reference_attention_varlen)
from mmer_tpu_torch.ops.fused_blocks import fused_ffn, layer_norm
from mmer_tpu_torch.ops.masked_ops import (attention_bias_from_pad_mask,
                                           masked_mean_pool)

from torch_threads import few_threads  # noqa: F401


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
    """Named for the time when ``key_lens`` raised ``NotImplementedError``:
    the call now goes through, a length of 4 of 8 keys equals attention over
    the first 4 keys, and what the wrapper cannot take is refused."""
    rng = np.random.default_rng(0)
    q, k, v = (_t(rng.normal(size=(1, 1, 8, 64))) for _ in range(3))
    got = flash_attention(q, k, v, key_lens=torch.tensor([4]))
    want = flash_attention(q, k[:, :, :4], v[:, :, :4])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, key_lens=torch.tensor([4, 4]))
    with pytest.raises(ValueError):
        flash_attention(q, k, v, key_lens=torch.tensor([4.0]))


@pytest.mark.parametrize("s", [199, 128])
def test_attention_varlen_matches_pallas_interpret(s):
    """Full, half, tile-boundary and zero lengths (tests/test_flash_varlen.py):
    valid rows against the Pallas varlen kernel in interpret mode, f32, where
    only the order of the sums differs; the zero-length clip's rows are
    finite, and are the mean of the S values (the Pallas kernel averages them
    over its zero-padded S instead, so they are not compared)."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(4, 4, s, 64)).astype(np.float32)
               for _ in range(3))
    lens = np.array([s, max(1, s // 2), 64, 0], np.int32)
    want = np.asarray(jax_attn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        key_lens=jnp.asarray(lens), interpret=True))
    got = flash_attention(_t(q), _t(k), _t(v),
                          key_lens=torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got[:3], want[:3], atol=2e-5, rtol=2e-5)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(
        got[3], np.broadcast_to(v[3].mean(axis=1, keepdims=True), got[3].shape),
        atol=1e-5)


def test_attention_varlen_full_lengths_equal_unmasked():
    """Lengths of S, and lengths beyond S (clamped), change nothing."""
    rng = np.random.default_rng(1)
    q, k, v = (_t(rng.normal(size=(2, 2, 96, 64))) for _ in range(3))
    want = flash_attention(q, k, v).numpy()
    for lens in ([96, 96], [96, 500]):
        got = flash_attention(q, k, v, key_lens=torch.tensor(lens)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_attention_varlen_bf16_rounding_points():
    """bf16 q, k, v with q and k doubled (scores of std ~4), a padded clip.
    The port's plain version has the rounding points of the JAX model's XLA
    attention (f32 scores, p rounded to bf16 after normalising): against that
    computation written in jnp only rare one-ulp flips remain.  Rounded scores
    read a mean error of 2^-7 of mean |out|, p left in f32 2^-9.5.  Against
    the Pallas varlen kernel, which rounds exp(s - max) before normalising,
    about a third of a bf16 ulp on average."""
    s = 199
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, 3, s, 64)).astype(np.float32)
               for _ in range(3))
    q, k = 2 * q, 2 * k
    lens = np.array([s, 120], np.int32)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    got = flash_attention(*(_t(a).bfloat16() for a in (q, k, v)),
                          key_lens=torch.from_numpy(lens))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()

    scores = jnp.einsum("bhqd,bhkd->bhqk", jq, jk,
                        preferred_element_type=jnp.float32) / 8.0
    pad = jnp.arange(s)[None, :] >= jnp.asarray(lens)[:, None]
    scores = scores + jnp.where(pad[:, None, None, :], -1e9, 0.0)
    import jax
    probs = jax.nn.softmax(scores, axis=-1).astype(jnp.bfloat16)
    plain = np.asarray(jnp.einsum(
        "bhqk,bhkd->bhqd", probs, jv, preferred_element_type=jnp.float32
    ).astype(jnp.bfloat16).astype(jnp.float32))
    d = np.abs(got - plain)
    assert d.max() <= 2 ** -8 * np.abs(plain).max()
    assert d.mean() <= 2 ** -14 * np.abs(plain).mean()
    pallas = np.asarray(jax_attn.flash_attention(
        jq, jk, jv, key_lens=jnp.asarray(lens), interpret=True
    ).astype(jnp.float32))
    d = np.abs(got - pallas)
    assert d.max() <= 2 ** -6 * np.abs(pallas).max()
    assert d.mean() <= 2 ** -8 * np.abs(pallas).mean()


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


# -- per-layer conv route (mega=False) and its two layer kernels -------------

def _layer_vectors(rng, c):
    return ((rng.normal(size=(c,)) * 0.1).astype(np.float32),
            (1.0 + rng.normal(size=(c,)) * 0.1).astype(np.float32),
            (rng.normal(size=(c,)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kdim,t_out", [(16, 21), (64, 10), (64, 9)])
def test_gemm_layer_matches_pallas_interpret(kdim, t_out, dtype):
    """Layer-0 patches (K = 16) and a kernel-2 merged block (K = 2C), an odd
    and an even length.  Real rows against the Pallas ``_gemm_kernel`` in
    interpret mode: f32 summation order only.  In bf16 XLA's CPU compiler
    fuses the kernel body and skips the epilogue's intermediate roundings, so
    about a quarter of the outputs sit one bf16 step away (bound of
    tests/test_conv_pyramid.py's bf16 case); the rounding points themselves
    are pinned by ``test_conv_layer_epilogue_bf16_rounding_points``.  The pad
    row (t_pad > rows of x) comes from zeros: finite."""
    rng = np.random.default_rng(kdim + t_out)
    c, t_pad = 32, t_out + t_out % 2
    x = rng.normal(size=(2, t_out, kdim)).astype(np.float32)
    w = (rng.normal(size=(kdim, c)) * kdim ** -0.5).astype(np.float32)
    cb, sc, bi = _layer_vectors(rng, c)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jax_conv._call_gemm(jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt),
                               jnp.asarray(cb), jnp.asarray(sc), jnp.asarray(bi),
                               t_out, t_pad, True)
    got = port_conv._call_gemm(_t(x).to(tdt), _t(w).to(tdt), _t(cb), _t(sc),
                               _t(bi), t_pad)
    assert got.shape == (2, t_pad, c) and got.dtype == tdt
    assert torch.isfinite(got.float()).all()
    diff = np.abs(got.float().numpy()[:, :t_out]
                  - np.asarray(want.astype(jnp.float32))[:, :t_out])
    if dtype == "float32":
        assert float(diff.max()) <= 2e-5
    else:
        assert float(diff.max()) <= 0.06 and float(diff.mean()) <= 2e-3


def test_conv_layer_epilogue_bf16_rounding_points():
    """The sums rounded to bf16, the bias added in bf16, LayerNorm in f32
    rounded to bf16, GELU in f32 rounded to bf16: the port's ``_epilogue``
    against the JAX ``_epilogue`` run op by op (``jax.disable_jit``, so that
    every rounding the source writes is taken), on the same f32 sums.  Bit
    for bit; leaving out or moving any one rounding changes over a quarter
    of the outputs."""
    import jax

    rng = np.random.default_rng(7)
    y32 = rng.normal(size=(2, 33, 64)).astype(np.float32) * 1.5
    cb, sc, bi = _layer_vectors(rng, 64)
    with jax.disable_jit():
        want = jax_conv._epilogue(jnp.asarray(y32), jnp.asarray(cb),
                                  jnp.asarray(sc), jnp.asarray(bi), jnp.bfloat16)
    got = port_conv._epilogue(_t(y32), _t(cb), _t(sc), _t(bi), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t_in", [21, 22, 40])
def test_k3_layer_matches_pallas_interpret(t_in, dtype):
    """Kernel-3 stride-2 conv on the merged view, odd and even input lengths:
    for odd T the last real output row takes its third tap from the pad
    row's first half.  Real rows against the Pallas ``_k3_kernel`` in
    interpret mode and against the conv written out tap by tap."""
    rng = np.random.default_rng(t_in)
    c = 32
    t_out = (t_in - 3) // 2 + 1
    t_pad = t_out + t_out % 2
    a = rng.normal(size=(2, t_in, c)).astype(np.float32)
    w = (rng.normal(size=(3, c, c)) * (3 * c) ** -0.5).astype(np.float32)
    cb, sc, bi = _layer_vectors(rng, c)
    a_pad = np.concatenate([a, np.zeros((2, t_in % 2, c), np.float32)], axis=1)
    xm = a_pad.reshape(2, -1, 2 * c)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jax_conv._call_k3(
        jnp.asarray(xm).astype(jdt), jnp.asarray(w[:2].reshape(2 * c, c)).astype(jdt),
        jnp.asarray(w[2]).astype(jdt), jnp.asarray(cb), jnp.asarray(sc),
        jnp.asarray(bi), t_out, t_pad, True)
    got = port_conv._call_k3(_t(xm).to(tdt), _t(w[:2].reshape(2 * c, c)).to(tdt),
                             _t(w[2]).to(tdt), _t(cb), _t(sc), _t(bi), t_pad)
    assert got.shape == (2, t_pad, c) and got.dtype == tdt
    assert torch.isfinite(got.float()).all()
    diff = np.abs(got.float().numpy()[:, :t_out]
                  - np.asarray(want.astype(jnp.float32))[:, :t_out])
    if dtype == "float32":
        assert float(diff.max()) <= 2e-5
        # The conv itself: out[t] = sum_j a[2t + j] . w[j].
        y = sum(np.einsum("btc,cd->btd", a[:, j:j + 2 * t_out:2][:, :t_out], w[j])
                for j in range(3))
        direct = port_conv._epilogue(_t(y), _t(cb), _t(sc), _t(bi), torch.float32)
        np.testing.assert_allclose(got.numpy()[:, :t_out], direct.numpy(),
                                   atol=2e-5, rtol=2e-5)
    else:
        assert float(diff.max()) <= 0.06 and float(diff.mean()) <= 2e-3


@pytest.mark.parametrize("length", [1600, 1923, 16000])
def test_conv_encoder_per_layer_matches_pallas_interpret(length):
    """``mega=False`` at the lengths of tests/test_conv_pyramid.py (odd and
    even frame counts at every layer boundary), the real 512-wide stack in
    f32: against the JAX per-layer route in interpret mode, the plain XLA
    module, and the port's own ``mega=True`` route."""
    jcfg = JaxWav2Vec2Config(compute_dtype="float32")
    cfg = Wav2Vec2Config(compute_dtype="float32")
    rng = np.random.default_rng(0)
    wave = rng.normal(size=(2, length)).astype(np.float32)
    params = _conv_params(jcfg)
    args = _port_conv_args(params, 7)
    got = fused_conv_encoder(_t(wave), *args, cfg, mega=False).numpy()
    want = jax_conv.fused_conv_encoder(jnp.asarray(wave), params["params"],
                                       jcfg, interpret=True, mega=False)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-4, rtol=2e-4)
    plain = JaxConvEncoder(jcfg).apply(params, jnp.asarray(wave))
    np.testing.assert_allclose(got, np.asarray(plain), atol=2e-4, rtol=2e-4)
    mega = fused_conv_encoder(_t(wave), *args, cfg, mega=True).numpy()
    np.testing.assert_allclose(got, mega, atol=2e-4, rtol=2e-4)


def test_conv_encoder_per_layer_bf16_rounding_points():
    """bf16: the per-layer route's plain versions take the Pallas
    ``_epilogue``'s rounding points (tolerance of tests/test_conv_pyramid.py's
    bf16 case, an odd length so the pad rows are in play)."""
    jcfg = JaxWav2Vec2Config(compute_dtype="bfloat16")
    cfg = Wav2Vec2Config(compute_dtype="bfloat16")
    rng = np.random.default_rng(1)
    wave = rng.normal(size=(2, 1923)).astype(np.float32)
    params = _conv_params(jcfg)
    got = fused_conv_encoder(_t(wave), *_port_conv_args(params, 7), cfg,
                             mega=False)
    assert got.dtype == torch.bfloat16
    want = jax_conv.fused_conv_encoder(jnp.asarray(wave), params["params"],
                                       jcfg, interpret=True, mega=False)
    diff = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    assert float(diff.max()) <= 0.06, float(diff.max())
    assert float(diff.mean()) <= 5e-3, float(diff.mean())


def test_l0_patches_match_jax():
    """Rows of k samples at stride s, zero past the waveform's end and in the
    columns that pad k to the tile depth (JAX pads to 8 lanes, the port to
    16: both give 16 for k = 10)."""
    rng = np.random.default_rng(2)
    wave = rng.normal(size=(2, 1923)).astype(np.float32)
    for t_pad in (383, 384, 390):
        want = jax_conv._l0_patches(jnp.asarray(wave), 10, 5, t_pad, jnp.float32)
        got = port_conv._l0_patches(_t(wave), 10, 5, t_pad, torch.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


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
