"""The order of operations of the per-layer conv GEMM kernel and the fused
LN-matmul kernel, on the CPU.

``csrc/conv_layers.cu:mmer_gemm_ln_gelu`` (the port of the Pallas
``_gemm_kernel``) has two bodies: for K >= 64 (the kernel-2 layers' merged
rows) the wgmma body of ``csrc/conv_tile.cuh`` (64-row tiles, 64-deep K steps
with the last one zero-filled, row t of the operand the K values at t * K, the
LayerNorm statistics of the two 256-channel halves added); for K < 64 (layer
0's patches) a CUDA-core kernel (each output summed k by k in f32, the
statistics a warp's sum in lane order).  ``tiled_gemm_reference`` repeats both.
``csrc/ln_matmul.cu`` (the port of ``_ln_matmul_kernel``) computes each
block's LayerNorm with ``common.cuh:ln_tile_bf16_sw128``'s statistics order and
sums the product over 64-deep K steps; ``ln_matmul_tiled_reference`` repeats
it, and ``ln_matmul_plan`` picks its grid.

Each emulation is held to the port's plain version and to the JAX function on
the same numpy-seeded inputs (``_call_gemm`` and ``fused_ln_matmul`` in
interpret mode, as the JAX package's own tests run them off a TPU), in f32 and
in bf16, at the ragged shapes the kernels must take.  Bounds, as
tests/test_torch_ops.py states them for the same pairs of functions:

- conv layer, f32: atol = rtol = 2e-5 (one layer, sums in another order);
  bf16: max 0.06, mean 2e-3
  (a flipped rounding of a sum moves an O(1) output by a few bf16 steps; the
  interpret-mode Pallas body also skips intermediate roundings);
- LN-matmul, f32: atol = rtol = 2e-5 (summation order only); bf16 against the
  plain version, the interpret-mode function and its body run op by op
  (``jax.disable_jit``, which takes every rounding the source writes): max
  2^-7 of max |out|, mean 2^-14 of mean |out| (only a flipped last rounding;
  the bound of tests/test_torch_cuda.py for the kernel against the same plain
  version).

The kernels themselves: tests/test_torch_cuda.py, on a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mmer_tpu.ops import conv_pyramid as jax_conv
from mmer_tpu.ops import fused_blocks as jax_blocks
from mmer_tpu_torch.ops.conv_pyramid import (CONV_ROWS, gemm_ln_gelu_reference,
                                             tiled_gemm_reference)
from mmer_tpu_torch.ops.fused_blocks import (LN_MATMUL_ROWS, LN_MATMUL_TILE,
                                             ln_matmul_plan, ln_matmul_reference,
                                             ln_matmul_tiled_reference)

from torch_threads import few_threads  # noqa: F401


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


# -- the per-layer conv GEMM (row 5) ------------------------------------------

def _gemm_case(kdim, t_out, c=64, batch=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, t_out, kdim)).astype(np.float32)
    w = (rng.normal(size=(kdim, c)) * kdim ** -0.5).astype(np.float32)
    vecs = ((rng.normal(size=(c,)) * 0.1).astype(np.float32),
            (1.0 + rng.normal(size=(c,)) * 0.1).astype(np.float32),
            (rng.normal(size=(c,)) * 0.1).astype(np.float32))
    return x, w, vecs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kdim", [16, 32, 48, 1024])
@pytest.mark.parametrize("t_out", [1, 63, 64, 65])
def test_tiled_gemm_matches_plain_and_pallas(t_out, kdim, dtype):
    """Three clips of t_out rows (1, the tile height - 1, itself, + 1), each
    padded to even t_pad: the pad row reads past the clip's rows (zeros).
    K 16 / 32 / 48 take the CUDA-core order, 1024 the wgmma body's 16 K steps."""
    x, w, vecs = _gemm_case(kdim, t_out, seed=kdim + t_out)
    t_pad = t_out + t_out % 2
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    targs = [_t(x, tdt), _t(w, tdt)] + [_t(v) for v in vecs]
    got = tiled_gemm_reference(*targs, t_pad)
    assert got.shape == (3, t_pad, 64) and got.dtype == tdt
    got = got.float().numpy()
    plain = gemm_ln_gelu_reference(*targs, t_pad).float().numpy()
    pallas = np.asarray(jax_conv._call_gemm(
        jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt),
        *(jnp.asarray(v) for v in vecs), t_out, t_pad, True).astype(jnp.float32))
    for want, rows in ((plain, t_pad), (pallas, t_out)):
        if dtype == "float32":
            np.testing.assert_allclose(got[:, :rows], want[:, :rows], atol=2e-5, rtol=2e-5)
        else:
            d = np.abs(got[:, :rows] - want[:, :rows])
            assert float(d.max()) <= 0.06 and float(d.mean()) <= 2e-3, (d.max(), d.mean())


@pytest.mark.parametrize("kdim", [16, 1024])
def test_tiled_gemm_never_reads_the_next_clip(kdim):
    """Clip 0 ends mid-tile (65 rows; t_pad 66 and the tile's other 62 rows
    lie past its array, where clip 1 starts).  They read zeros: changing the
    later clips changes none of clip 0's bits, and the result equals the one
    computed from explicit zero rows."""
    x, w, vecs = _gemm_case(kdim, 65, seed=5)
    args = [_t(w)] + [_t(v) for v in vecs]
    want = tiled_gemm_reference(_t(x), *args, 66)
    other = x.copy()
    other[1:] += 100.0
    assert torch.equal(tiled_gemm_reference(_t(other), *args, 66)[0], want[0])
    padded = np.concatenate([x, np.zeros((3, CONV_ROWS - 1, kdim), np.float32)], axis=1)
    alone = tiled_gemm_reference(_t(padded), *args, 66)
    torch.testing.assert_close(want, alone, atol=0, rtol=0)


# -- the fused LN-matmul (row 7) ----------------------------------------------

def _ln_matmul_case(n_tok, n, d=768, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(1, n_tok, d)).astype(np.float32),
            (1.0 + rng.normal(size=(d,)) * 0.1).astype(np.float32),
            (rng.normal(size=(d,)) * 0.1).astype(np.float32),
            (rng.normal(size=(d, n)) * 0.05).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [64, 192, 2304])
@pytest.mark.parametrize("n_tok", [1, 63, 64, 65])
def test_ln_matmul_tiled_matches_plain_and_pallas(n_tok, n, dtype):
    """Token counts around the 64-row block; N of one 64-column group, a
    partial 256-column tile, and nine whole tiles; D = 768."""
    x, scale, bias, w = _ln_matmul_case(n_tok, n, seed=n_tok + n)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    targs = (_t(x, tdt), _t(scale), _t(bias), _t(w.T, tdt).contiguous())
    got = ln_matmul_tiled_reference(*targs)
    assert got.shape == (1, n_tok, n) and got.dtype == tdt
    got = got.float().numpy()
    plain = ln_matmul_reference(*targs).float().numpy()
    xj, wj = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    pallas = np.asarray(jax_blocks.fused_ln_matmul(
        xj, jnp.asarray(scale), jnp.asarray(bias), wj, interpret=True).astype(jnp.float32))
    if dtype == "float32":
        for want in (plain, pallas):
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
        return
    with jax.disable_jit():
        y = jax_blocks._ln_rows(xj.astype(jnp.float32), scale, bias).astype(jdt)
        body = np.asarray(jnp.dot(y, wj, preferred_element_type=jnp.float32)
                          .astype(jdt).astype(jnp.float32))
    for want in (plain, body, pallas):
        d = np.abs(got - want)
        assert float(d.max()) <= 2 ** -7 * float(np.abs(want).max()), float(d.max())
        assert float(d.mean()) <= 2 ** -14 * float(np.abs(want).mean()), float(d.mean())


def test_ln_matmul_tiled_statistics_order():
    """The kernel's LayerNorm statistics (a lane's chunks in order, then the
    xor butterfly) agree with a plain sum to f32 rounding: on rows of a large
    common offset, where a naive E[x^2] - E[x]^2 loses most digits, the two
    orders still give LN outputs within a bf16 step."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(4, 1024)) + 20.0).astype(np.float32)
    ones, zeros = np.ones(1024, np.float32), np.zeros(1024, np.float32)
    eye = np.eye(1024, dtype=np.float32)
    got = ln_matmul_tiled_reference(_t(x), _t(ones), _t(zeros), _t(eye))
    want = ln_matmul_reference(_t(x), _t(ones), _t(zeros), _t(eye))
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)


# -- the grid plan ------------------------------------------------------------

_SHAPES = st.tuples(st.integers(1, 40000), st.integers(1, 60).map(lambda c: 64 * c),
                    st.sampled_from([1, 66, 108, 132, 144]))


@settings(max_examples=200, deadline=None)
@given(_SHAPES)
def test_ln_matmul_plan_tiles_the_work_exactly(shape):
    """Every 256-column tile of N goes to exactly one slice, none empty."""
    n_tok, n, sms = shape
    rows, n_split = ln_matmul_plan(n_tok, n, sms)
    tiles = -(-n // LN_MATMUL_TILE)
    assert rows == LN_MATMUL_ROWS and 1 <= n_split <= tiles
    ranges = [(y * tiles // n_split, (y + 1) * tiles // n_split) for y in range(n_split)]
    assert ranges[0][0] == 0 and ranges[-1][1] == tiles
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(n_split - 1))


@settings(max_examples=200, deadline=None)
@given(_SHAPES)
def test_ln_matmul_plan_fills_the_card_when_the_work_allows(shape):
    n_tok, n, sms = shape
    rows, n_split = ln_matmul_plan(n_tok, n, sms)
    row_tiles, tiles = -(-n_tok // rows), -(-n // LN_MATMUL_TILE)
    assert row_tiles * n_split >= min(sms, row_tiles * tiles)
    if row_tiles >= sms:
        assert n_split == 1          # each block computes its LayerNorm once


@settings(max_examples=100, deadline=None)
@given(_SHAPES)
def test_ln_matmul_plan_depends_on_the_shape_alone(shape):
    assert ln_matmul_plan(*shape) == ln_matmul_plan(*shape)


@pytest.mark.parametrize("n_tok,n,want", [
    (16 * 1569, 2304, (64, 1)),       # the profile script's LN -> QKV: 393 x 1
    (4 * 149, 3072, (64, 12)),        # the Wav2Vec2 width: 10 x 12 = 120 blocks
    (1, 64, (64, 1)), (65, 2304, (64, 9))])
def test_ln_matmul_plan_at_the_main_shapes(n_tok, n, want):
    assert ln_matmul_plan(n_tok, n, 132) == want
