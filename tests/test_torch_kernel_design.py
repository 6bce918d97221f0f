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

``ffn_plan``, the host function that picks the FFN grid, is checked with
hypothesis.  The kernels themselves: tests/test_torch_cuda.py, on a GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mmer_tpu.ops import flash_attention as jax_attn
from mmer_tpu.ops import fused_blocks as jax_blocks
from mmer_tpu_torch.ops.flash_attention import (KEY_TILE, reference_attention,
                                                reference_attention_varlen,
                                                tiled_attention_reference)
from mmer_tpu_torch.ops.fused_blocks import (FFN_CHUNK, FFN_D_SPLIT, FFN_ROWS,
                                             ffn_plan, ffn_reference,
                                             ffn_slices, ffn_split_reference)


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
