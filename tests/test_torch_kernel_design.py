"""The order of operations of the port's redesigned CUDA kernels, on the CPU.

The attention and fused-FFN kernels (``mmer_tpu_torch/csrc/attention.cu``,
``ffn.cu``) cannot run without a GPU, but what they compute, tile by tile and
slice by slice, can: ``tiled_attention_reference`` repeats the attention
kernel's online softmax over 64-key tiles (mask on edge tiles only, tiles past
a clip's length skipped, P rounded before P.V, the denominator from the
rounded P), ``ffn_split_reference`` the FFN's split into D and M slices with
the partial tiles reduced in slice order.  Both are held here against the
port's plain versions and against the JAX kernels run as the JAX package's
own tests run them off a TPU (``interpret=True``), on the same numpy-seeded
inputs, under the bounds tests/test_torch_ops.py states for the same pairs of
functions:

- f32 attention: atol = rtol = 1e-5 (2e-5 with key lengths): only the order
  of the sums differs;
- bf16 attention against the Pallas kernel: max 2^-6 of max |out|, mean 2^-8
  of mean |out| (both round exp(s - max) before normalising; against the plain
  version, which rounds after, the same bound);
- f32 FFN: atol = rtol = 2e-5; bf16 FFN: max 2^-7 of max |out|, mean 1e-5 (same
  rounding points, only f32 summation order can flip a bf16 rounding).

The conv-encoder kernels (``csrc/conv_encoder.cu``, ``conv_layers.cu``'s
kernel-3 layers) share one body, ``csrc/conv_tile.cuh``:
``tiled_conv_encoder_reference`` and ``tiled_k3_reference`` repeat its
schedule (64-row tiles, 64-deep K steps over the im2col rows or the merged
view with zero fill past each clip's end, LayerNorm statistics of the two
channel halves added, layer 0 summed tap by tap on its own path).  They are
held to the plain versions and to the JAX functions in interpret mode under
the bounds of tests/test_torch_ops.py: f32 atol = rtol = 2e-4 (seven layers
of K <= 1536 sums in another order; 2e-5 for one layer), bf16 max 0.06 and
mean 5e-3 (a flipped rounding propagates through the next LayerNorm; one
layer against the Pallas kernel, whose interpret mode skips intermediate
roundings: max 0.06, mean 2e-3).

``ffn_plan``, the host function that picks the FFN grid, is checked with
hypothesis.  The kernels themselves: tests/test_torch_cuda.py, on a GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mmer_tpu.config import Wav2Vec2Config as JaxWav2Vec2Config
from mmer_tpu.models.wav2vec2 import ConvFeatureEncoder as JaxConvEncoder
from mmer_tpu.ops import conv_pyramid as jax_conv
from mmer_tpu.ops import flash_attention as jax_attn
from mmer_tpu.ops import fused_blocks as jax_blocks
from mmer_tpu_torch.config import Wav2Vec2Config
from mmer_tpu_torch.models.convert import conv_encoder_from_flax
from mmer_tpu_torch.ops.conv_pyramid import (CONV_ROWS, conv_encoder_reference,
                                             halves_row_stats, k3_ln_gelu_reference,
                                             lane_row_stats,
                                             tiled_conv_encoder_reference,
                                             tiled_k3_reference)
from mmer_tpu_torch.ops.flash_attention import (KEY_TILE, reference_attention,
                                                reference_attention_varlen,
                                                tiled_attention_reference)
from mmer_tpu_torch.ops.fused_blocks import (FFN_CHUNK, FFN_D_SPLIT, FFN_ROWS,
                                             ffn_plan, ffn_reference,
                                             ffn_slices, ffn_split_reference)

from torch_threads import few_threads  # noqa: F401


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _qkv(seed, b, h, s, gain=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, s, 64)).astype(np.float32) for _ in range(3))
    return gain * q, gain * k, v


# -- attention ---------------------------------------------------------------

@pytest.mark.parametrize("s", [40, 64, 65, 200])
def test_tiled_attention_f32_matches_plain_and_pallas(s):
    """Ragged S around the 64-key tile: one partial tile, exactly one, one
    plus one key, three plus eight."""
    q, k, v = _qkv(0, 2, 3, s)
    got = tiled_attention_reference(_t(q), _t(k), _t(v)).numpy()
    plain = reference_attention(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, plain, atol=1e-5, rtol=1e-5)
    pallas = jax_attn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("s", [40, 200])
def test_tiled_attention_bf16_rounding_points(s):
    """q and k doubled (scores of std ~4).  P is rounded before it is
    normalised, as in the Pallas kernel."""
    q, k, v = _qkv(0, 2, 3, s, gain=2.0)
    tq = [_t(a).bfloat16() for a in (q, k, v)]
    jq = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    got = tiled_attention_reference(*tq)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    for want in (np.asarray(jax_attn.flash_attention(*jq, interpret=True)
                            .astype(jnp.float32)),
                 reference_attention(*tq).float().numpy()):
        d = np.abs(got - want)
        assert d.max() <= 2 ** -6 * np.abs(want).max()
        assert d.mean() <= 2 ** -8 * np.abs(want).mean()


@pytest.mark.parametrize("s", [130, 199])
def test_tiled_attention_key_lens_f32(s):
    """Lengths S, beyond S (clamped), a tile boundary, one past it, 1 and 0.
    Valid clips against the plain version and the Pallas varlen kernel; the
    empty clip is the mean of its S values (the Pallas kernel averages over
    its zero-padded S instead, so that clip is compared with the plain
    version alone)."""
    q, k, v = _qkv(1, 6, 2, s)
    lens = np.array([s, s + 9, 64, 65, 1, 0], np.int32)
    got = tiled_attention_reference(_t(q), _t(k), _t(v),
                                    torch.from_numpy(lens)).numpy()
    plain = reference_attention_varlen(_t(q), _t(k), _t(v),
                                       torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, plain, atol=2e-5, rtol=2e-5)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(
        got[5], np.broadcast_to(v[5].mean(axis=1, keepdims=True), got[5].shape),
        atol=1e-5)
    pallas = np.asarray(jax_attn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        key_lens=jnp.asarray(np.minimum(lens, s)), interpret=True))
    np.testing.assert_allclose(got[:5], pallas[:5], atol=2e-5, rtol=2e-5)


def test_tiled_attention_key_lens_bf16():
    q, k, v = _qkv(0, 3, 3, 199, gain=2.0)
    lens = np.array([199, 120, 65], np.int32)
    tq = [_t(a).bfloat16() for a in (q, k, v)]
    jq = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    got = tiled_attention_reference(*tq, torch.from_numpy(lens)).float().numpy()
    for want in (np.asarray(jax_attn.flash_attention(
                     *jq, key_lens=jnp.asarray(lens), interpret=True
                 ).astype(jnp.float32)),
                 reference_attention_varlen(
                     *tq, torch.from_numpy(lens)).float().numpy()):
        d = np.abs(got - want)
        assert d.max() <= 2 ** -6 * np.abs(want).max()
        assert d.mean() <= 2 ** -8 * np.abs(want).mean()


def test_tiled_attention_skips_tiles_past_len():
    """Keys and values in tiles wholly past a clip's length are never read:
    NaNs planted there change nothing, while NaNs inside the tile that holds
    the length would (its keys are multiplied by a probability of 0)."""
    s, n = 199, 70                      # len 70: tiles [0,64) and [64,128)
    q, k, v = (_t(a) for a in _qkv(2, 1, 2, s))
    lens = torch.tensor([n])
    want = tiled_attention_reference(q, k, v, lens)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 2 * KEY_TILE:] = float("nan")
    v2[:, :, 2 * KEY_TILE:] = float("nan")
    assert torch.equal(tiled_attention_reference(q, k2, v2, lens), want)
    v2[:, :, n:] = float("nan")
    assert torch.isnan(tiled_attention_reference(q, k, v2, lens)).all()
    # A padded clip equals unmasked attention over its own keys alone (the
    # CPU matmul sums a 6-key and a 64-key tile in other orders).
    alone = tiled_attention_reference(q[:, :, :n], k[:, :, :n], v[:, :, :n])
    np.testing.assert_allclose(want[:, :, :n].numpy(), alone.numpy(), atol=1e-6)


# -- fused FFN ---------------------------------------------------------------

def _ffn_inputs(seed, tokens, d, m):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(x=rng.normal(size=(1, tokens, d)).astype(f),
                scale=(rng.normal(size=(d,)) * 0.1 + 1.0).astype(f),
                bias=(rng.normal(size=(d,)) * 0.1).astype(f),
                w1=(rng.normal(size=(d, m)) * 0.05).astype(f),
                b1=(rng.normal(size=(m,)) * 0.1).astype(f),
                w2=(rng.normal(size=(m, d)) * 0.05).astype(f),
                b2=(rng.normal(size=(d,)) * 0.1).astype(f))


_KEYS = ("x", "scale", "bias", "w1", "b1", "w2", "b2")


def _port_args(p, cast=()):
    """nn.Linear layouts, w1 (M, D) and w2 (D, M); ``cast`` names go to bf16."""
    t = {key: _t(p[key]) for key in _KEYS}
    for key in cast:
        t[key] = t[key].bfloat16()
    return [t["x"], t["scale"], t["bias"], t["w1"].t().contiguous(), t["b1"],
            t["w2"].t().contiguous(), t["b2"]]


@pytest.mark.parametrize("m_split", [1, 2, 3])
def test_ffn_split_f32_matches_plain_and_pallas(m_split):
    """Three chunks of 256 hidden units in one, two (1 + 2 chunks) and three
    slices, two D slices each, 37 token rows."""
    p = _ffn_inputs(1, 37, 64, 3 * FFN_CHUNK)
    got = ffn_split_reference(*_port_args(p), m_split).numpy()
    plain = ffn_reference(*_port_args(p)).numpy()
    np.testing.assert_allclose(got, plain, atol=2e-5, rtol=2e-5)
    pallas = jax_blocks.fused_ffn(*(jnp.asarray(p[key]) for key in _KEYS),
                                  interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("caller", ["vivit", "wav2vec2"])
@pytest.mark.parametrize("m_split", [1, 2])
def test_ffn_split_bf16_rounding_points(m_split, caller):
    """Both streams: ViViT a bf16 x with f32 biases, Wav2Vec2 an f32 x with
    bf16 biases.  The hidden units are rounded once, inside their slice; a
    sum of slices that rounded them twice, or rounded the partial tiles,
    would exceed the mean bound (1.6e-4 or more)."""
    p = _ffn_inputs(1, 50, 32, 2 * FFN_CHUNK)
    cast = ("w1", "w2") + (("x",) if caller == "vivit" else ("b1", "b2"))
    targs = _port_args(p, cast)
    jd = {key: jnp.asarray(p[key]) for key in _KEYS}
    for key in cast:
        jd[key] = jd[key].astype(jnp.bfloat16)
    got = ffn_split_reference(*targs, m_split)
    assert got.dtype == targs[0].dtype
    got = got.float().numpy()
    for want in (np.asarray(jax_blocks.fused_ffn(*(jd[key] for key in _KEYS),
                                                 interpret=True)
                            .astype(jnp.float32)),
                 ffn_reference(*targs).float().numpy()):
        diff = np.abs(got - want)
        assert float(diff.max()) <= 2 ** -7 * float(np.abs(want).max())
        assert float(diff.mean()) <= 1e-5, float(diff.mean())


def test_ffn_split_is_the_same_on_every_call():
    p = _ffn_inputs(3, 20, 32, 2 * FFN_CHUNK)
    a = ffn_split_reference(*_port_args(p), 2)
    assert torch.equal(a, ffn_split_reference(*_port_args(p), 2))


# -- conv encoder ------------------------------------------------------------

# A three-layer stack of the supported family (layer 0, one kernel-3 and one
# kernel-2 stride-2 layer), 64 channels: K = 192 and 128, three and two K
# steps.  The lengths put the last layer's t_out at 1, the tile height - 1,
# the tile height and + 1; the layers before it run odd and even lengths.
_STACK = dict(conv_kernels=(10, 3, 2), conv_strides=(5, 2, 2), conv_dims=(64, 64, 64))
_LENGTHS = {34: (5, 2, 1), 1285: (256, 127, 63), 1290: (257, 128, 64),
            1320: (263, 131, 65)}


def _conv_case(length, dtype, stack=_STACK, batch=3, seed=0):
    """JAX config and params, the port's config and arguments, a waveform
    batch of clips whose ends fall mid-tile."""
    import jax

    jcfg = JaxWav2Vec2Config(compute_dtype=dtype, **stack)
    cfg = Wav2Vec2Config(compute_dtype=dtype, **stack)
    params = JaxConvEncoder(jcfg).init({"params": jax.random.PRNGKey(seed)},
                                       jnp.zeros((1, 1600), jnp.float32))
    sd = conv_encoder_from_flax(params)
    n = len(cfg.conv_dims)
    args = [[sd[f"{kind}.{i}.{name}"] for i in range(n)]
            for kind, name in (("convs", "weight"), ("convs", "bias"),
                               ("norms", "weight"), ("norms", "bias"))]
    wave = np.random.default_rng(seed).normal(size=(batch, length)).astype(np.float32)
    return jcfg, params, cfg, args, wave


@pytest.mark.parametrize("length", sorted(_LENGTHS))
def test_tiled_conv_encoder_f32_matches_plain_and_pallas(length):
    jcfg, params, cfg, args, wave = _conv_case(length, "float32")
    got = tiled_conv_encoder_reference(_t(wave), *args, cfg)
    assert got.shape == (3, _LENGTHS[length][-1], 64)
    got = got.numpy()
    plain = conv_encoder_reference(_t(wave), *args, cfg).numpy()
    np.testing.assert_allclose(got, plain, atol=2e-4, rtol=2e-4)
    pallas = jax_conv.fused_conv_encoder(jnp.asarray(wave), params["params"], jcfg,
                                         interpret=True, mega=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("length", [1285, 1320])
def test_tiled_conv_encoder_bf16_rounding_points(length):
    jcfg, params, cfg, args, wave = _conv_case(length, "bfloat16", seed=1)
    got = tiled_conv_encoder_reference(_t(wave), *args, cfg)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    for want in (conv_encoder_reference(_t(wave), *args, cfg).float().numpy(),
                 np.asarray(jax_conv.fused_conv_encoder(
                     jnp.asarray(wave), params["params"], jcfg, interpret=True,
                     mega=True), np.float32)):
        diff = np.abs(got - want)
        assert float(diff.max()) <= 0.06, float(diff.max())
        assert float(diff.mean()) <= 5e-3, float(diff.mean())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_conv_encoder_at_the_real_widths(dtype):
    """The seven 512-wide layers (K = 1536 and 1024: 24 and 16 K steps, two
    halves of 256 channels), 1,923 samples: odd and even lengths."""
    stack = dict(conv_kernels=(10, 3, 3, 3, 3, 2, 2),
                 conv_strides=(5, 2, 2, 2, 2, 2, 2), conv_dims=(512,) * 7)
    jcfg, params, cfg, args, wave = _conv_case(1923, dtype, stack, batch=2, seed=2)
    got = tiled_conv_encoder_reference(_t(wave), *args, cfg).float().numpy()
    pallas = np.asarray(jax_conv.fused_conv_encoder(
        jnp.asarray(wave), params["params"], jcfg, interpret=True, mega=True), np.float32)
    plain = conv_encoder_reference(_t(wave), *args, cfg).float().numpy()
    for want in (plain, pallas):
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
        else:
            diff = np.abs(got - want)
            assert float(diff.max()) <= 0.06 and float(diff.mean()) <= 5e-3


@pytest.mark.parametrize("c", [64, 512])
def test_row_stats_orders_agree_with_a_plain_sum(c):
    """The two kernels' orders of the LayerNorm sums (the wgmma body's two
    channel halves, layer 0's 32 lanes) agree with a plain sum to f32
    rounding; at 64 channels lanes 16-31 hold nothing."""
    y = torch.randn(3, 5, c, generator=torch.Generator().manual_seed(c))
    for row_stats in (halves_row_stats, lane_row_stats):
        s, ss = row_stats(y)
        assert s.shape == ss.shape == (3, 5, 1)
        torch.testing.assert_close(s, y.sum(-1, keepdim=True), atol=1e-4, rtol=1e-5)
        torch.testing.assert_close(ss, (y * y).sum(-1, keepdim=True), atol=1e-4, rtol=1e-5)


def _k3_case(t_in, c=64, batch=3, seed=0):
    """A (batch, t_in, c) activation padded to even length (the pad row is
    zero, as the merged view of an odd-length layer holds), viewed as merged
    rows; weights split as the per-layer route splits them."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(batch, t_in + t_in % 2, c)).astype(np.float32)
    a[:, t_in:] = 0.0
    w = (rng.normal(size=(3, c, c)) * (3 * c) ** -0.5).astype(np.float32)
    vecs = ((rng.normal(size=(c,)) * 0.1).astype(np.float32),
            (1.0 + rng.normal(size=(c,)) * 0.1).astype(np.float32),
            (rng.normal(size=(c,)) * 0.1).astype(np.float32))
    t_out = (t_in - 3) // 2 + 1
    return a.reshape(batch, -1, 2 * c), w[:2].reshape(2 * c, c), w[2], vecs, t_out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t_in", [3, 127, 128, 129, 131, 262])
def test_tiled_k3_layer_matches_plain_and_pallas(t_in, dtype):
    """t_out 1, 63, 63, 64, 65 and 130 (the tile height - 1, itself, + 1, and
    not a multiple of it); odd and even input lengths (the last row of an odd
    one takes its third tap from the pad row, of an even one from past the
    clip's end: zeros); three clips, each ending mid-tile."""
    xm, w01, w2, vecs, t_out = _k3_case(t_in, seed=t_in)
    t_pad = t_out + t_out % 2
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    targs = [_t(a).to(tdt) for a in (xm, w01, w2)] + [_t(v) for v in vecs]
    got = tiled_k3_reference(*targs, t_pad)
    assert got.shape == (3, t_pad, 64) and got.dtype == tdt
    got = got.float().numpy()[:, :t_out]
    plain = k3_ln_gelu_reference(*targs, t_pad).float().numpy()[:, :t_out]
    pallas = np.asarray(jax_conv._call_k3(
        *(jnp.asarray(a).astype(jdt) for a in (xm, w01, w2)),
        *(jnp.asarray(v) for v in vecs), t_out, t_pad, True).astype(jnp.float32))[:, :t_out]
    if dtype == "float32":
        np.testing.assert_allclose(got, plain, atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=2e-5)
    else:
        d = np.abs(got - plain)
        assert float(d.max()) <= 0.06 and float(d.mean()) <= 2e-3
        d = np.abs(got - pallas)
        assert float(d.max()) <= 0.06 and float(d.mean()) <= 2e-3


def test_tiled_k3_never_reads_the_next_clip():
    """An even input length: the last output row's third tap lies past the
    clip's array, where the next clip starts.  It reads zeros: changing the
    next clip changes nothing in this one, and the row equals the one
    computed from an explicit zero row."""
    xm, w01, w2, vecs, t_out = _k3_case(128, seed=5)
    t_pad = t_out + t_out % 2
    assert t_pad == xm.shape[1] and t_pad % CONV_ROWS == 0
    args = [_t(a) for a in (xm, w01, w2)] + [_t(v) for v in vecs]
    want = tiled_k3_reference(*args, t_pad)
    other = xm.copy()
    other[1:] += 100.0
    got = tiled_k3_reference(_t(other), *args[1:], t_pad)
    assert torch.equal(got[0], want[0])
    padded = np.concatenate([xm, np.zeros_like(xm[:, :1])], axis=1)
    alone = tiled_k3_reference(_t(padded), *args[1:], t_pad)
    torch.testing.assert_close(want, alone, atol=0, rtol=0)


# -- the grid plan -----------------------------------------------------------

_SHAPES = st.tuples(st.integers(1, 40000), st.sampled_from([768, 1024]),
                    st.integers(1, 24).map(lambda c: c * FFN_CHUNK),
                    st.sampled_from([1, 66, 108, 132, 144]))


@settings(max_examples=200, deadline=None)
@given(_SHAPES)
def test_ffn_plan_tiles_the_work_exactly(shape):
    n_tok, d, m, sms = shape
    rows, d_split, m_split = ffn_plan(n_tok, d, m, sms)
    assert (rows, d_split) == (FFN_ROWS, FFN_D_SPLIT) and d % d_split == 0
    assert 1 <= m_split <= m // FFN_CHUNK
    slices = ffn_slices(m, m_split)
    assert len(slices) == m_split and slices[0][0] == 0 and slices[-1][1] == m
    for (a0, a1), (b0, _) in zip(slices, slices[1:] + [(m, m)]):
        assert a0 < a1 == b0 and a0 % FFN_CHUNK == 0      # no gap, none empty


@settings(max_examples=200, deadline=None)
@given(_SHAPES)
def test_ffn_plan_fills_the_card_when_the_work_allows(shape):
    n_tok, d, m, sms = shape
    rows, d_split, m_split = ffn_plan(n_tok, d, m, sms)
    row_blocks = -(-n_tok // rows) * d_split
    if row_blocks >= sms:
        assert m_split == 1              # a full grid keeps its sums in registers
    else:
        assert row_blocks * m_split >= sms or m_split == m // FFN_CHUNK
        # ... and with no more slices than that takes.
        assert m_split == 1 or row_blocks * (m_split - 1) < sms


@settings(max_examples=100, deadline=None)
@given(_SHAPES)
def test_ffn_plan_depends_on_the_shape_alone(shape):
    assert ffn_plan(*shape) == ffn_plan(*shape)
    n_tok, d, m, sms = shape
    # The same plan for every token count that gives the same row tiles.
    first = (n_tok - 1) // FFN_ROWS * FFN_ROWS + 1
    assert ffn_plan(first, d, m, sms) == ffn_plan(n_tok, d, m, sms)


@pytest.mark.parametrize("n_tok,d,m,want", [
    (149, 1024, 4096, 16),       # a 3 s clip: 3 row tiles x 2 x 16 = 96 blocks
    (1500, 1024, 4096, 3),       # 30 s of pieces: 24 x 2 x 3 = 144 blocks
    (65, 768, 3072, 12),         # two row tiles
    (12552, 768, 3072, 1),       # 8 ViViT chunks: 197 x 2 blocks
    (15936, 1024, 4096, 1),      # the extraction forward
])
def test_ffn_plan_at_the_main_paths_shapes(n_tok, d, m, want):
    assert ffn_plan(n_tok, d, m, 132) == (64, 2, want)
    with pytest.raises(ValueError):
        ffn_plan(n_tok, d, m + 128, 132)


# -- the serving profile script ------------------------------------------------

def test_profile_serve_script_runs_on_cpu():
    from mmer_tpu_torch.scripts import profile_serve

    rows = profile_serve.main(["--device", "cpu", "--tiny", "--repeats", "1"])
    assert [r["name"].split()[0] for r in rows] == ["predict_chunks",
                                                    "predict_chunks",
                                                    "infer_sequence"]
    for r in rows:
        assert r["device"] == "cpu" and r["wall_ms"] > 0
        assert "idle_share" not in r            # no device numbers off a card
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            profile_serve.main(["--tiny"])


def test_compare_builds_script_needs_the_card(tmp_path):
    """It launches kernels of two builds: without a card it raises, on the
    CPU too (no plain fallback: there would be nothing to compare)."""
    from mmer_tpu_torch.scripts import compare_builds

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        compare_builds.main(["--other", str(tmp_path)])
