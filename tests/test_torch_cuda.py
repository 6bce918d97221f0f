"""The hand-written CUDA kernels against their plain PyTorch versions, on a
GPU.

Every test here needs a CUDA device and skips without one; the file imports
neither JAX nor ``mmer_tpu``, so it runs on a machine that has only PyTorch
and the CUDA toolkit:

    python -m pytest -o addopts= tests/test_torch_cuda.py

(``-o addopts=`` drops the CPU-mesh plugin the repository's pytest settings
load, which a GPU machine without JAX does not need.)

Shapes cover the ragged edges the main path's shapes do not: sequences and
token counts that are not multiples of the kernels' 64-row tiles, every
plan of the FFN's grid (one and several slices of the hidden dimension),
conv layers whose output lengths sit around the conv kernels' 64-row tiles,
and conv stacks whose last layers have fewer frames than one block.  No
kernel uses atomics: the same call twice must give the same bits.
Tolerances are chip_smoke.py's, with the same reasons, except for
attention, whose bound here scales with the output (see the test).
"""

import dataclasses

import pytest
import torch

from mmer_tpu_torch.config import Wav2Vec2Config
from mmer_tpu_torch.models.wav2vec2 import feat_extract_output_length
from mmer_tpu_torch.ops import conv_pyramid
from mmer_tpu_torch.ops.conv_pyramid import (conv_encoder_reference,
                                             fused_conv_encoder,
                                             gemm_ln_gelu_reference,
                                             k3_ln_gelu_reference,
                                             tiled_conv_encoder_reference,
                                             tiled_gemm_reference,
                                             tiled_k3_reference)
from mmer_tpu_torch.ops.flash_attention import (flash_attention,
                                                flash_attention_varlen,
                                                reference_attention,
                                                reference_attention_varlen,
                                                tiled_attention_reference)
from mmer_tpu_torch.ops.attention_variants import (MODES, attention_variant,
                                                   attention_variant_reference)
from mmer_tpu_torch.ops.fused_blocks import (ffn_reference,
                                             ffn_split_reference, fused_ffn,
                                             fused_ln_matmul, ln_matmul_plan,
                                             ln_matmul_reference,
                                             ln_matmul_tiled_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


def _err(got, want):
    d = (got.float() - want.float()).abs()
    return float(d.max()), float(d.mean())


@pytest.mark.parametrize("s", [1, 63, 64, 65, 157, 1569])
def test_attention_kernel_matches_plain(cuda, s):
    g = _gen(cuda)
    q, k, v = (torch.randn(2, 3, s, 64, generator=g, device=cuda).bfloat16()
               for _ in range(3))
    n0 = flash_attention.launches
    got = flash_attention(q, k, v)
    assert flash_attention.launches == n0 + 1
    want = reference_attention(q, k, v)
    mx, mean = _err(got, want)
    # Kernel and plain version round the probabilities to bf16 at different
    # points (before / after normalising), so outputs differ by about a
    # third of a bf16 ulp on average; an ulp scales with |output|, which
    # grows as S shrinks.  A wrong tile or mask errs by ~|output| itself.
    scale = want.float().abs()
    assert mx <= 2 ** -6 * float(scale.max()), (mx, float(scale.max()))
    assert mean <= 2 ** -7 * float(scale.mean()), (mean, float(scale.mean()))


@pytest.mark.parametrize("s", [157, 1569])
def test_attention_kernel_sharp_scores(cuda, s):
    """q and k tripled, so the scores have a std of ~9: the kernel must keep
    them in f32 (rounded to bf16 they err by ~2^-4 of max |output|)."""
    g = _gen(cuda, 1)
    q, k, v = (torch.randn(2, 3, s, 64, generator=g, device=cuda)
               for _ in range(3))
    q, k, v = (3 * q).bfloat16(), (3 * k).bfloat16(), v.bfloat16()
    got = flash_attention(q, k, v)
    want = reference_attention(q, k, v)
    mx, mean = _err(got, want)
    scale = want.float().abs()
    assert mx <= 2 ** -6 * float(scale.max()), (mx, float(scale.max()))
    assert mean <= 2 ** -7 * float(scale.mean()), (mean, float(scale.mean()))


@pytest.mark.parametrize("s", [49, 64, 149, 199, 249, 499])
def test_varlen_attention_kernel_matches_plain(cuda, s):
    """Ragged S with lengths S, beyond S (clamped), a tile boundary, a
    partial tile, 1 and 0; batch 6 x 16 heads as Wav2Vec2's.  Valid clips
    under the bound of the unmasked kernel; the zero-length clip is finite and
    the mean of its S values (every key carries the same bias)."""
    g = _gen(cuda)
    q, k, v = (torch.randn(6, 16, s, 64, generator=g, device=cuda).bfloat16()
               for _ in range(3))
    lens = torch.tensor([s, s + 7, min(64, s), max(1, (2 * s) // 3), 1, 0],
                        device=cuda)
    n0, m0 = flash_attention_varlen.launches, flash_attention.launches
    got = flash_attention(q, k, v, key_lens=lens)
    assert flash_attention_varlen.launches == n0 + 1
    assert flash_attention.launches == m0
    want = reference_attention_varlen(q, k, v, lens)
    assert torch.isfinite(got.float()).all()
    mx, mean = _err(got[:5], want[:5])
    scale = want[:5].float().abs()
    assert mx <= 2 ** -6 * float(scale.max()), (mx, float(scale.max()))
    assert mean <= 2 ** -7 * float(scale.mean()), (mean, float(scale.mean()))
    uniform = v[5].float().mean(-2, keepdim=True).expand_as(got[5])
    assert float((got[5].float() - uniform).abs().max()) <= 2 ** -7
    # A padded clip equals the unmasked kernel on its own keys alone.
    n = int(lens[3])
    alone = flash_attention(q[3:4, :, :n].contiguous(), k[3:4, :, :n].contiguous(),
                            v[3:4, :, :n].contiguous())
    assert torch.equal(got[3, :, :n], alone[0])


def test_varlen_attention_kernel_sharp_scores(cuda):
    """q and k tripled (scores of std ~9) at the extraction shape's S."""
    g = _gen(cuda, 1)
    q, k, v = (torch.randn(4, 16, 199, 64, generator=g, device=cuda)
               for _ in range(3))
    q, k, v = (3 * q).bfloat16(), (3 * k).bfloat16(), v.bfloat16()
    lens = torch.tensor([199, 150, 64, 77], device=cuda, dtype=torch.int32)
    got = flash_attention(q, k, v, key_lens=lens)
    want = reference_attention_varlen(q, k, v, lens)
    mx, mean = _err(got, want)
    scale = want.float().abs()
    assert mx <= 2 ** -6 * float(scale.max()), (mx, float(scale.max()))
    assert mean <= 2 ** -7 * float(scale.mean()), (mean, float(scale.mean()))


@pytest.mark.parametrize("n_tok", [1, 31, 33, 135])
@pytest.mark.parametrize("x_dtype,d,m", [(torch.bfloat16, 768, 3072),
                                         (torch.float32, 1024, 4096)])
def test_ffn_kernel_matches_plain(cuda, n_tok, x_dtype, d, m):
    g = _gen(cuda)
    x = torch.randn(n_tok, d, generator=g, device=cuda).to(x_dtype)
    w1 = (torch.randn(m, d, generator=g, device=cuda) * d ** -0.5).bfloat16()
    w2 = (torch.randn(d, m, generator=g, device=cuda) * m ** -0.5).bfloat16()
    vec = [torch.randn(n, generator=g, device=cuda) * 0.1 for n in (d, d, m, d)]
    args = (x, vec[0] + 1, vec[1], w1, vec[2], w2, vec[3])
    n0 = fused_ffn.launches
    got = fused_ffn(*args)
    assert fused_ffn.launches == n0 + 1
    assert got.dtype == x_dtype and got.shape == x.shape
    mx, mean = _err(got, ffn_reference(*args))
    if x_dtype == torch.bfloat16:
        assert mx <= 0.0625 and mean <= 1e-3, (mx, mean)
    else:
        assert mx <= 2e-3 and mean <= 1e-4, (mx, mean)


def _ffn_args(dev, tokens, x_dtype, d, m, seed=0):
    g = _gen(dev, seed)
    x = torch.randn(*tokens, d, generator=g, device=dev).to(x_dtype)
    w1 = (torch.randn(m, d, generator=g, device=dev) * d ** -0.5).bfloat16()
    w2 = (torch.randn(d, m, generator=g, device=dev) * m ** -0.5).bfloat16()
    vec = [torch.randn(n, generator=g, device=dev) * 0.1 for n in (d, d, m, d)]
    return (x, vec[0] + 1, vec[1], w1, vec[2], w2, vec[3])


@pytest.mark.parametrize("tokens,x_dtype,d,m,m_split,tol", [
    ((65,), torch.bfloat16, 768, 3072, 12, (0.0625, 1e-3)),
    ((65,), torch.float32, 1024, 4096, 16, (4e-3, 1e-4)),
    ((1, 1500), torch.float32, 1024, 4096, 3, (4e-3, 1e-4)),
    ((8, 1569), torch.bfloat16, 768, 3072, 1, (0.0625, 1e-3)),
    ((12552,), torch.float32, 1024, 4096, 1, (8e-3, 1e-4)),
])
def test_ffn_kernel_plans_match_plain_and_repeat(cuda, tokens, x_dtype, d, m,
                                                 m_split, tol):
    """One row tile past a boundary (65 = 64 + 1), the longest serving piece
    (1,500 frames), the ViViT batch (12,552 = 196 x 64 + 8) in both streams:
    every plan a main path reaches, the reduce pass counted when there is
    one, chip_smoke.py's bounds, and the same bits on a second call."""
    if torch.cuda.get_device_properties(cuda).multi_processor_count != 132:
        pytest.skip("the expected plans are those of a 132-SM card")
    args = _ffn_args(cuda, tokens, x_dtype, d, m, seed=7)
    n0, r0 = fused_ffn.launches, fused_ffn.reduce_launches
    got = fused_ffn(*args)
    assert fused_ffn.launches == n0 + 1
    assert fused_ffn.reduce_launches == r0 + (m_split > 1)
    assert fused_ffn.last_plan == (64, 2, m_split)
    assert got.dtype == x_dtype and got.shape == args[0].shape
    mx, mean = _err(got, ffn_reference(*args))
    assert mx <= tol[0] and mean <= tol[1], (mx, mean)
    assert torch.equal(got, fused_ffn(*args))
    if m_split > 1:
        # The kernel's own order of sums, in plain PyTorch.
        mx, mean = _err(got, ffn_split_reference(*args, m_split))
        assert mx <= tol[0] and mean <= tol[1], (mx, mean)


@pytest.mark.parametrize("s", [64, 65, 1569])
def test_attention_kernel_is_the_same_on_every_call(cuda, s):
    g = _gen(cuda, 3)
    q, k, v = (torch.randn(2, 12, s, 64, generator=g, device=cuda).bfloat16()
               for _ in range(3))
    assert torch.equal(flash_attention(q, k, v), flash_attention(q, k, v))
    lens = torch.tensor([s, max(1, s // 3)], device=cuda)
    assert torch.equal(flash_attention(q, k, v, key_lens=lens),
                       flash_attention(q, k, v, key_lens=lens))
    for mode in ("nomask", "noexp", "mxumask", "kt_nosoftmax"):
        assert torch.equal(attention_variant(q, k, v, mode),
                           attention_variant(q, k, v, mode))


def test_varlen_attention_kernel_at_the_extraction_length(cuda):
    """S = 249 (3 x 64 + 57 query rows: a last block that is partly
    padding) with lengths 0, 1, a key-tile boundary, one past it, and S: the
    mask runs on the tile that holds the length and on no other."""
    s = 249
    g = _gen(cuda, 4)
    q, k, v = (torch.randn(5, 16, s, 64, generator=g, device=cuda).bfloat16()
               for _ in range(3))
    lens = torch.tensor([0, 1, 64, 65, 249], device=cuda)
    got = flash_attention(q, k, v, key_lens=lens)
    want = reference_attention_varlen(q, k, v, lens)
    assert torch.isfinite(got.float()).all()
    mx, mean = _err(got[1:], want[1:])
    scale = want[1:].float().abs()
    assert mx <= 2 ** -6 * float(scale.max()), (mx, float(scale.max()))
    assert mean <= 2 ** -7 * float(scale.mean()), (mean, float(scale.mean()))
    uniform = v[0].float().mean(-2, keepdim=True).expand_as(got[0])
    assert float((got[0].float() - uniform).abs().max()) <= 2 ** -7
    # One key: every query row is that key's value row, exactly.
    assert torch.equal(got[1], v[1, :, :1].expand_as(got[1]))
    # The tiled order of operations in plain PyTorch, on two heads.
    tiled = tiled_attention_reference(q[:, :2].cpu(), k[:, :2].cpu(),
                                      v[:, :2].cpu(), lens.cpu())
    mx, mean = _err(got[1:, :2].cpu(), tiled[1:])
    assert mx <= 2 ** -6 * float(scale.max()) and mean <= 2 ** -9 * float(scale.mean())


def _conv_args(cfg, dev):
    g = _gen(dev, 1)
    layers, c_in = [], 1
    for dim, kk in zip(cfg.conv_dims, cfg.conv_kernels):
        layers.append((torch.randn(dim, c_in, kk, generator=g, device=dev)
                       * (kk * c_in) ** -0.5,
                       torch.randn(dim, generator=g, device=dev) * 0.1,
                       1 + torch.randn(dim, generator=g, device=dev) * 0.1,
                       torch.randn(dim, generator=g, device=dev) * 0.1))
        c_in = dim
    return [list(t) for t in zip(*layers)]


@pytest.mark.parametrize("batch,length", [(1, 400), (2, 1923), (2, 16000),
                                          (4, 48000)])
def test_conv_encoder_kernel_matches_plain(cuda, batch, length):
    """400 samples is the stack's receptive field: one output frame."""
    cfg = Wav2Vec2Config()
    args = _conv_args(cfg, cuda)
    wave = torch.randn(batch, length, generator=_gen(cuda, 2), device=cuda)
    n0 = fused_conv_encoder.launches
    got = fused_conv_encoder(wave, *args, cfg)
    assert fused_conv_encoder.launches == n0 + len(cfg.conv_dims)
    t = feat_extract_output_length(cfg, length)
    assert got.shape == (batch, t, 512) and got.dtype == torch.bfloat16
    want = conv_encoder_reference(wave, *args, cfg)
    mx, mean = _err(got, want)
    assert mx <= 0.06 and mean <= 5e-3, (mx, mean)
    exact = conv_encoder_reference(
        wave, *args, dataclasses.replace(cfg, compute_dtype="float32"))
    assert _err(got, exact)[1] <= 1.25 * _err(want, exact)[1]


def _layer_operands(dev, batch, rows, kdim, seed=3):
    g = _gen(dev, seed)
    x = torch.randn(batch, rows, kdim, generator=g, device=dev).bfloat16()
    w = (torch.randn(kdim, 512, generator=g, device=dev) * kdim ** -0.5).bfloat16()
    vecs = [torch.randn(512, generator=g, device=dev) * 0.1 for _ in range(3)]
    return x, w, (vecs[0], 1 + vecs[1], vecs[2])


@pytest.mark.parametrize("batch,rows,kdim,t_pad", [
    (1, 1, 16, 2), (3, 79, 16, 80), (2, 383, 16, 384),      # layer-0 patches
    (3, 33, 1024, 34), (2, 24, 1024, 24), (1, 7, 1024, 4)])  # k=2 merged rows
def test_gemm_layer_kernel_matches_plain(cuda, batch, rows, kdim, t_pad):
    """Rows not a multiple of the 64-row tile, batch > 1, t_pad above the
    operand's rows (the pad row comes from zeros) and below them; K = 16 runs
    the CUDA-core kernel, K = 1024 the wgmma body."""
    x, w, vecs = _layer_operands(cuda, batch, rows, kdim)
    n0 = conv_pyramid._call_gemm.launches
    got = conv_pyramid._call_gemm(x, w, *vecs, t_pad)
    assert conv_pyramid._call_gemm.launches == n0 + 1
    assert got.shape == (batch, t_pad, 512) and got.dtype == torch.bfloat16
    mx, mean = _err(got, gemm_ln_gelu_reference(x, w, *vecs, t_pad))
    # One layer: a flipped bf16 rounding of the conv sum moves the output by
    # at most a few bf16 steps of an O(1) value.
    assert mx <= 0.0625 and mean <= 1e-3, (mx, mean)


@pytest.mark.parametrize("kdim", [16, 32, 48, 80, 1024])
@pytest.mark.parametrize("t_out", [1, 63, 64, 65])
def test_gemm_layer_kernel_ragged_tiles_and_repeat(cuda, kdim, t_out):
    """Output lengths around the 64-row tile, each of three clips holding
    t_out rows padded to even t_pad (the pad row reads past the clip's
    array: zeros, never the next clip); K 16 / 32 / 48 on the CUDA-core
    kernel, 80 (a zero-filled last K step) and 1024 on the wgmma body.  Within
    the layer bound of the plain version and of the kernel's order of
    operations; one launch a call on a 64-row block a tile of each clip; the
    same bits on a second call."""
    x, w, vecs = _layer_operands(cuda, 3, t_out, kdim, seed=kdim + t_out)
    t_pad = t_out + t_out % 2
    n0 = conv_pyramid._call_gemm.launches
    got = conv_pyramid._call_gemm(x, w, *vecs, t_pad)
    assert conv_pyramid._call_gemm.launches == n0 + 1
    assert conv_pyramid._call_gemm.last_grid == (-(-t_pad // 64), 3)
    assert got.shape == (3, t_pad, 512) and torch.isfinite(got.float()).all()
    for ref in (gemm_ln_gelu_reference(x, w, *vecs, t_pad),
                tiled_gemm_reference(x, w, *vecs, t_pad)):
        mx, mean = _err(got, ref)
        assert mx <= 0.0625 and mean <= 1e-3, (mx, mean)
    assert torch.equal(got, conv_pyramid._call_gemm(x, w, *vecs, t_pad))


@pytest.mark.parametrize("kdim", [16, 1024])
def test_gemm_layer_kernel_never_reads_the_next_clip(cuda, kdim):
    """Clip 0 ends mid-tile (65 rows, t_pad 66): changing the clips after it
    changes none of its bits, on either body."""
    x, w, vecs = _layer_operands(cuda, 3, 65, kdim, seed=7)
    got = conv_pyramid._call_gemm(x, w, *vecs, 66)
    other = x.clone()
    other[1:] += 100.0
    assert torch.equal(got[0], conv_pyramid._call_gemm(other, w, *vecs, 66)[0])


@pytest.mark.parametrize("batch,t_in", [(1, 3), (3, 79), (2, 80), (2, 81),
                                        (3, 82), (2, 799), (4, 6399)])
def test_k3_layer_kernel_matches_plain(cuda, batch, t_in):
    """Odd and even input lengths, odd and even output lengths (81 and 82
    frames give 40, whose last row reads a merged row that exists): for odd T
    the last real row's third tap is the pad row's first half; the rows past
    the real output read zeros, never
    the next clip's frames (each clip is checked against the plain version,
    which pads per clip)."""
    t_pad_in = t_in + t_in % 2
    a, w, vecs = _layer_operands(cuda, batch, t_pad_in, 512, seed=t_in)
    if t_in % 2:
        a[:, -1] = 0
    g = _gen(cuda, 5)
    w01 = (torch.randn(1024, 512, generator=g, device=cuda) * 1536 ** -0.5).bfloat16()
    xm = a.view(batch, t_pad_in // 2, 1024)
    t_out = (t_in - 3) // 2 + 1
    t_pad = t_out + t_out % 2
    n0 = conv_pyramid._call_k3.launches
    got = conv_pyramid._call_k3(xm, w01, w, *vecs, t_pad)
    assert conv_pyramid._call_k3.launches == n0 + 1
    assert got.shape == (batch, t_pad, 512)
    assert torch.isfinite(got.float()).all()
    mx, mean = _err(got, k3_ln_gelu_reference(xm, w01, w, *vecs, t_pad))
    assert mx <= 0.0625 and mean <= 1e-3, (mx, mean)


@pytest.mark.parametrize("batch,length", [(1, 400), (2, 1923), (2, 16000),
                                          (4, 48000), (3, 64000)])
def test_conv_encoder_per_layer_route_matches_plain_and_mega(cuda, batch, length):
    """``mega=False``: 3 gemm + 4 k3 launches, within the conv-encoder bound
    of its plain version and of the whole-pyramid route (two independent
    hand-written formulations), and as close to the f32 path as the plain
    bf16 version."""
    cfg = Wav2Vec2Config()
    args = _conv_args(cfg, cuda)
    wave = torch.randn(batch, length, generator=_gen(cuda, 2), device=cuda)
    counts = [w.launches for w in (conv_pyramid._call_gemm, conv_pyramid._call_k3,
                                   fused_conv_encoder)]
    got = fused_conv_encoder(wave, *args, cfg, mega=False)
    assert [w.launches for w in (conv_pyramid._call_gemm, conv_pyramid._call_k3,
                                 fused_conv_encoder)] == \
        [counts[0] + 3, counts[1] + 4, counts[2]]
    t = feat_extract_output_length(cfg, length)
    assert got.shape == (batch, t, 512) and got.dtype == torch.bfloat16
    want = conv_encoder_reference(wave, *args, cfg)
    mx, mean = _err(got, want)
    assert mx <= 0.06 and mean <= 5e-3, (mx, mean)
    mx, mean = _err(got, fused_conv_encoder(wave, *args, cfg, mega=True))
    assert mx <= 0.06 and mean <= 5e-3, (mx, mean)
    exact = conv_encoder_reference(
        wave, *args, dataclasses.replace(cfg, compute_dtype="float32"))
    assert _err(got, exact)[1] <= 1.25 * _err(want, exact)[1]


@pytest.mark.parametrize("batch,length", [(3, 400), (3, 20240), (3, 20560),
                                          (3, 20880), (4, 48000)])
def test_conv_encoder_kernel_ragged_tiles_and_repeat(cuda, batch, length):
    """Last-layer lengths 1, 63, 64, 65 (one 64-row tile less one, exactly,
    plus one) and 149 (the serving shape, 4 x 48,000 samples), every earlier
    layer at other odd and even lengths: within the conv bound of the plain
    version and of the kernels' order of operations in plain PyTorch, as
    close to the f32 path as the plain version, seven launches a call, the
    same bits on a second call, a 64-row block a tile of each clip."""
    cfg = Wav2Vec2Config()
    args = _conv_args(cfg, cuda)
    wave = torch.randn(batch, length, generator=_gen(cuda, 6), device=cuda)
    n0 = fused_conv_encoder.launches
    got = fused_conv_encoder(wave, *args, cfg)
    assert fused_conv_encoder.launches == n0 + len(cfg.conv_dims)
    t = feat_extract_output_length(cfg, length)
    assert got.shape == (batch, t, 512) and t in (1, 63, 64, 65, 149)
    want = conv_encoder_reference(wave, *args, cfg)
    for ref in (want, tiled_conv_encoder_reference(wave, *args, cfg)):
        mx, mean = _err(got, ref)
        assert mx <= 0.06 and mean <= 5e-3, (mx, mean)
    exact = conv_encoder_reference(
        wave, *args, dataclasses.replace(cfg, compute_dtype="float32"))
    assert _err(got, exact)[1] <= 1.25 * _err(want, exact)[1]
    assert torch.equal(got, fused_conv_encoder(wave, *args, cfg))
    assert fused_conv_encoder.launches == n0 + 2 * len(cfg.conv_dims)
    lengths, n = [], length
    for k, s in zip(cfg.conv_kernels, cfg.conv_strides):
        n = (n - k) // s + 1
        lengths.append(n)
    assert fused_conv_encoder.last_grids == [(-(-n // 64), batch) for n in lengths]


def _k3_operands(dev, batch, t_in, seed):
    """An activation of t_in frames padded to even length with a zero row,
    as merged rows, and the split weights."""
    a, w2, vecs = _layer_operands(dev, batch, t_in + t_in % 2, 512, seed=seed)
    a[:, t_in:] = 0
    g = _gen(dev, seed + 1)
    w01 = (torch.randn(1024, 512, generator=g, device=dev) * 1536 ** -0.5).bfloat16()
    return a.view(batch, -1, 1024), w01, w2, vecs


@pytest.mark.parametrize("parity", [1, 0])
@pytest.mark.parametrize("t_out", [1, 63, 64, 65, 149])
def test_k3_layer_kernel_ragged_tiles_and_repeat(cuda, t_out, parity):
    """Output lengths around the 64-row tile, from an odd (2 t_out + 1) and
    an even (2 t_out + 2) input length: the last row of an odd one takes its
    third tap from the zero pad row, the pad row of an even one reads past the
    clip's array (zeros, never the next clip).  Within the layer bound of the
    plain version and of the kernel's order of operations; one launch a call;
    the same bits on a second call."""
    t_in = 2 * t_out + 2 - parity
    xm, w01, w2, vecs = _k3_operands(cuda, 3, t_in, seed=t_in)
    t_pad = t_out + t_out % 2
    n0 = conv_pyramid._call_k3.launches
    got = conv_pyramid._call_k3(xm, w01, w2, *vecs, t_pad)
    assert conv_pyramid._call_k3.launches == n0 + 1
    assert got.shape == (3, t_pad, 512) and torch.isfinite(got.float()).all()
    for ref in (k3_ln_gelu_reference(xm, w01, w2, *vecs, t_pad),
                tiled_k3_reference(xm, w01, w2, *vecs, t_pad)):
        mx, mean = _err(got, ref)
        assert mx <= 0.0625 and mean <= 1e-3, (mx, mean)
    assert torch.equal(got, conv_pyramid._call_k3(xm, w01, w2, *vecs, t_pad))
    assert conv_pyramid._call_k3.launches == n0 + 2


def test_k3_layer_kernel_at_the_even_extraction_length(cuda):
    """16,001 frames in (8,001 merged rows), 8,000 out: the last row reads a
    merged row that exists.  Two clips of the extraction shape."""
    xm, w01, w2, vecs = _k3_operands(cuda, 2, 16002, seed=11)
    got = conv_pyramid._call_k3(xm, w01, w2, *vecs, 8000)
    mx, mean = _err(got, k3_ln_gelu_reference(xm, w01, w2, *vecs, 8000))
    assert mx <= 0.0625 and mean <= 1e-3, (mx, mean)
    assert torch.equal(got, conv_pyramid._call_k3(xm, w01, w2, *vecs, 8000))


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    g = _gen(cuda)
    q = torch.randn(1, 1, 8, 32, generator=g, device=cuda).bfloat16()
    with pytest.raises(ValueError):          # head dim 32
        flash_attention(q, q, q)
    q = torch.randn(1, 1, 8, 64, generator=g, device=cuda)
    with pytest.raises(TypeError):           # f32
        flash_attention(q, q, q)
    q = torch.randn(2, 1, 8, 64, generator=g, device=cuda).bfloat16()
    with pytest.raises(ValueError):          # one length for two clips
        flash_attention(q, q, q, key_lens=torch.tensor([4], device=cuda))
    with pytest.raises(TypeError):           # f32 with key lengths
        flash_attention(q.float(), q.float(), q.float(),
                        key_lens=torch.tensor([4, 4], device=cuda))
    x, w, vecs = _layer_operands(cuda, 1, 8, 16)
    with pytest.raises(TypeError):           # f32 rows
        conv_pyramid._call_gemm(x.float(), w, *vecs, 8)
    with pytest.raises(ValueError):          # K = 8, not a multiple of 16
        conv_pyramid._call_gemm(x[..., :8].contiguous(), w[:8].contiguous(),
                                *vecs, 8)
    with pytest.raises(ValueError):          # 256 channels
        conv_pyramid._call_k3(torch.zeros(1, 4, 512, device=cuda).bfloat16(),
                              torch.zeros(512, 512, device=cuda).bfloat16(),
                              torch.zeros(256, 512, device=cuda).bfloat16(),
                              *vecs, 2)
    x = torch.randn(4, 512, generator=g, device=cuda).bfloat16()
    w = torch.zeros(1024, 512, device=cuda).bfloat16()
    vec = torch.zeros(1024, device=cuda)
    with pytest.raises(ValueError):          # D = 512
        fused_ffn(x, vec[:512], vec[:512], w, vec, w.t().contiguous(), vec[:512])
    cfg = Wav2Vec2Config(compute_dtype="float32")
    with pytest.raises(TypeError):           # f32 compute dtype
        fused_conv_encoder(torch.zeros(1, 1600, device=cuda),
                           *_conv_args(Wav2Vec2Config(), cuda), cfg)
    cfg = Wav2Vec2Config(conv_kernels=(17, 3, 3, 3, 3, 2, 2))
    with pytest.raises(ValueError, match="mega=False"):    # 17 layer-0 taps
        fused_conv_encoder(torch.zeros(1, 1600, device=cuda), *_conv_args(cfg, cuda), cfg)


@pytest.mark.parametrize("tokens,d,n,x_dtype", [
    ((1,), 768, 64, torch.bfloat16), ((63,), 768, 192, torch.bfloat16),
    ((5, 13), 1024, 320, torch.float32), ((130,), 768, 2304, torch.bfloat16),
    ((3, 333), 1024, 3072, torch.float32)])
def test_ln_matmul_kernel_matches_plain(cuda, tokens, d, n, x_dtype):
    """Token counts around the 64-row block (1, 63, 65, 130, 999), both
    widths, N from one 64-column group to several 256-column tiles with a
    partial last one (320 = 256 + 64, 2304 = 9 x 256), both stream dtypes;
    the output takes the weight's dtype."""
    g = _gen(cuda)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=cuda) * std

    x = randn(*tokens, d).to(x_dtype)
    ln_w, ln_b = 1.0 + randn(d, std=0.1), randn(d, std=0.1)
    w = randn(n, d, std=d ** -0.5).bfloat16()
    n0 = fused_ln_matmul.launches
    got = fused_ln_matmul(x, ln_w, ln_b, w)
    assert fused_ln_matmul.launches == n0 + 1
    assert got.shape == (*tokens, n) and got.dtype == torch.bfloat16
    want = ln_matmul_reference(x, ln_w, ln_b, w)
    mx, mean = _err(got, want)
    # Same rounding points: summation order can flip the last bf16 rounding,
    # one ulp (at most 2^-7 of the value) for a few outputs.
    scale = want.float().abs()
    assert mx <= 2 ** -7 * float(scale.max()), (mx, float(scale.max()))
    assert mean <= 2 ** -14 * float(scale.mean()), (mean, float(scale.mean()))


def _ln_matmul_operands(dev, tokens, d, n, x_dtype, seed):
    g = _gen(dev, seed)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    return (randn(*tokens, d).to(x_dtype), 1.0 + randn(d, std=0.1), randn(d, std=0.1),
            randn(n, d, std=d ** -0.5).bfloat16())


@pytest.mark.parametrize("n_tok", [1, 63, 64, 65])
@pytest.mark.parametrize("n,d,x_dtype", [(64, 768, torch.bfloat16),
                                         (192, 1024, torch.float32),
                                         (2304, 768, torch.bfloat16)])
def test_ln_matmul_kernel_ragged_tiles_and_repeat(cuda, n_tok, n, d, x_dtype):
    """Token counts around the 64-row block, N of one 64-column group, a
    partial 256-column tile, and nine whole tiles; both widths and stream
    dtypes.  Within the bound of the plain version and of the kernel's order
    of operations; the grid from ln_matmul_plan; the same bits on a second
    call."""
    args = _ln_matmul_operands(cuda, (n_tok,), d, n, x_dtype, seed=n_tok + n)
    got = fused_ln_matmul(*args)
    assert got.shape == (n_tok, n) and got.dtype == torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert fused_ln_matmul.last_plan == ln_matmul_plan(n_tok, n, sms)
    for ref in (ln_matmul_reference(*args), ln_matmul_tiled_reference(*args)):
        mx, mean = _err(got, ref)
        scale = ref.float().abs()
        assert mx <= 2 ** -7 * float(scale.max()), (mx, float(scale.max()))
        assert mean <= 2 ** -14 * float(scale.mean()), (mean, float(scale.mean()))
    assert torch.equal(got, fused_ln_matmul(*args))


def test_ln_matmul_kernel_fills_the_card_at_the_wav2vec2_width(cuda):
    """(4, 149) f32 tokens x (3072, 1024): ten row tiles, so the plan spreads
    N over at least 120 blocks; the result does not depend on the plan."""
    args = _ln_matmul_operands(cuda, (4, 149), 1024, 3072, torch.float32, seed=9)
    got = fused_ln_matmul(*args)
    rows, n_split = fused_ln_matmul.last_plan
    assert -(-596 // rows) * n_split >= 120
    mx, _ = _err(got, ln_matmul_tiled_reference(*args))
    assert mx <= 2 ** -7 * float(got.float().abs().max())
    assert torch.equal(got, fused_ln_matmul(*args))


def test_ln_matmul_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(4, 768, device=cuda, dtype=torch.bfloat16)
    vec = torch.ones(768, device=cuda)
    w = torch.zeros(128, 768, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        fused_ln_matmul(x, vec, vec, w.float())
    with pytest.raises(ValueError):
        fused_ln_matmul(x, vec, vec, w[:100].contiguous())      # N % 64
    with pytest.raises(ValueError):
        fused_ln_matmul(x[:, :512].contiguous(), vec[:512], vec[:512],
                        w[:, :512].contiguous())                # D
    with pytest.raises(ValueError):
        fused_ln_matmul(x, vec, vec, w.t())                     # not contiguous


@pytest.mark.parametrize("s,s_pad", [(50, 64), (64, 64), (65, 128), (157, 192),
                                     (1569, 1664)])
@pytest.mark.parametrize("mode", MODES)
def test_attention_variant_kernels_match_plain(cuda, mode, s, s_pad):
    """Every probe mode at sequence lengths around the 64-row tiles, padded
    by less than, exactly and more than one key tile.  The two ``p = scores``
    modes divide by a sum of signed scores and are compared, as implied
    numerators, on the rows whose plain |denominator| is at least 4."""
    g = _gen(cuda, 2)
    q, k, v = (torch.randn(2, 3, s, 64, generator=g, device=cuda).bfloat16()
               for _ in range(3))
    n0, f0 = attention_variant.launches[mode], flash_attention.launches
    got = attention_variant(q, k, v, mode, s_pad)
    assert attention_variant.launches[mode] == n0 + 1
    assert flash_attention.launches == f0 + (mode == "full")
    want, num, den = attention_variant_reference(q, k, v, mode, s_pad,
                                                 return_parts=True)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    if mode in ("nosoftmax", "kt_nosoftmax"):
        keep = (den.abs() >= 4.0).squeeze(-1)
        assert float(keep.float().mean()) > 0.4
        implied = ((got.float() - want.float()).abs() * den.abs())[keep]
        assert torch.isfinite(implied).all()
        assert float(implied.max()) <= 2 ** -6 * float(num[keep].abs().max())
        assert float(implied.mean()) <= 2 ** -9 * float(num[keep].abs().mean())
        return
    assert torch.isfinite(got.float()).all()
    mx, mean = _err(got, want)
    scale = want.float().abs()
    assert mx <= 2 ** -6 * float(scale.max()), (mx, float(scale.max()))
    assert mean <= 2 ** -7 * float(scale.mean()), (mean, float(scale.mean()))
    if mode in ("mxumask", "kt"):
        mx, _ = _err(got, flash_attention(q, k, v))
        assert mx <= 2 ** -6 * float(scale.max())


def test_attention_variant_kernel_needs_whole_key_tiles(cuda):
    q = torch.zeros(1, 1, 50, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="s_pad"):
        attention_variant(q, q, q, "nomask", s_pad=100)
    with pytest.raises(TypeError):
        attention_variant(q.float(), q.float(), q.float(), "noexp", s_pad=64)


# -- the threefry kernel (ops/prng.py) ------------------------------------------------

def _step_draws(b, t=5):
    """A training step's draws at ModelConfig() width and batch ``b``: the
    11 bfloat16 / float32 masks, ``u`` and the sort keys of ``j``."""
    from mmer_tpu_torch.config import ModelConfig
    from mmer_tpu_torch.models.fusion import dropout_draws
    from mmer_tpu_torch.ops import prng

    return (dropout_draws(ModelConfig(), b, t)
            + [prng.Draw((103,), (b,), "uniform")]
            + prng.permutation_draws((102,), b))


@pytest.mark.parametrize("b,lanes", [(64, None), (256, None), (64, 4), (1, 3)])
def test_threefry_kernel_equals_its_plain_version(cuda, b, lanes):
    """Every kind the kernel writes, bit for bit its plain version, the
    step folded in by the kernel, one launch a draw call, the same bits on
    a second call."""
    from mmer_tpu_torch.ops import prng

    plan = prng.DrawPlan(_step_draws(b), cuda, lanes=lanes)
    keys = [(0x1234 + i, 0x9ABCDEF0 - i) for i in range(lanes or 1)]
    before = prng.launch_threefry.launches
    got = plan.draw(keys, step=107)
    assert prng.launch_threefry.launches == before + 1
    want = plan.draw_plain(keys, step=107)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    for g, again in zip(got, plan.draw(keys, step=107)):
        assert torch.equal(g, again)


@pytest.mark.parametrize("n", [2, 64, 6796, 70_001])
def test_threefry_kernel_bits_and_permutations(cuda, n):
    """``random_bits`` on a CUDA index (any flat indices, through the kernel)
    and ``permutation`` (its rounds' sort keys in one launch) against the
    plain int64 versions."""
    from mmer_tpu_torch.ops import prng

    key = prng.PRNGKey(42)
    idx = torch.arange(n, device=cuda) * 3 + 2 ** 32 - 7      # high words too
    assert torch.equal(prng.random_bits(key, idx).cpu(),
                       prng.random_bits_plain(key, idx.cpu()))
    assert torch.equal(prng.permutation(key, n, cuda).cpu(),
                       prng.permutation(key, n, "cpu"))



def test_threefry_kernel_tails_and_index_arrays(cuda):
    """The vector stores' edges, bit for bit the plain version: three lanes
    of draws of odd sizes (a bfloat16 mask of 15, a uniform of 5, sort keys
    of 7: every lane after the first starts unaligned, every range ends on a
    partial group), a draw of more than one work range, and index plans
    with high counter words and odd counts."""
    from mmer_tpu_torch.ops import prng

    draws = ([prng.Draw((77,), (3, 5), "mask", 0.9, torch.bfloat16),
              prng.Draw((78,), (1029,), "mask", 0.5, torch.float32),
              prng.Draw((79,), (3, 7), "bits"),
              prng.Draw((103,), (5,), "uniform")]
             + prng.permutation_draws((102,), 7))
    keys = [(11, 12), (13, 14), (15, 16)]
    plan = prng.DrawPlan(draws, cuda, lanes=3)
    for g, w in zip(plan.draw(keys, step=3), plan.draw_plain(keys, step=3)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    for n in (1, 3, 1027, 5 * 1024 + 3):
        idx = torch.arange(n, device=cuda) * 5 + 2 ** 32 - 11
        plan = prng.DrawPlan([prng.Draw((), (n,), "bits")], cuda, index=idx)
        assert torch.equal(plan.draw([(7, 8)])[0], plan.draw_plain([(7, 8)])[0])


def test_threefry_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from mmer_tpu_torch.ops import prng

    table = prng.DrawPlan(_step_draws(8), cuda).table
    out = torch.empty(64, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        prng.launch_threefry(table.cpu(), [(0, 1)], 0, 8, out)
    with pytest.raises(ValueError):
        prng.launch_threefry(table, [(0, 1)] * 17, 0, 8, out)
    with pytest.raises(ValueError, match="work list"):
        prng.launch_threefry(table, [(0, 1)], 0, table, out)
    with pytest.raises(ValueError):
        prng.DrawPlan([prng.Draw((), (4,), "mask", 0.9, torch.float16)], cuda)


# -- the int8 products (csrc/qdot.cu) -----------------------------------------

def _quant_rows(dev, m, k, dtype, seed):
    """Unit-normal rows with an all-zero row and a row of exact .5 quotients
    (absmax 127, so the scale is 1 and x / xs is x itself)."""
    x = torch.randn(m, k, generator=_gen(dev, seed), device=dev) * 3
    if m > 2:
        x[1] = 0
        x[2] = torch.arange(k, device=dev) % 254 - 126.5
        x[2, 0] = 127
    return x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k", [(1, 8), (3, 64), (37, 768), (300, 3072),
                                 (2, 4096), (5, 4104), (3, 8192)])
def test_row_quant_kernel_equals_plain(cuda, dtype, m, k):
    from mmer_tpu_torch.ops.quant import row_quant, row_quant_reference

    x = _quant_rows(cuda, m, k, dtype, m + k)
    n0 = row_quant.launches
    q, s = row_quant(x)
    assert row_quant.launches == n0 + 1
    q_ref, s_ref = row_quant_reference(x)
    torch.cuda.synchronize()
    assert q.dtype == torch.int8 and s.shape == (m, 1)
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    q2, s2 = row_quant(x)
    assert torch.equal(q, q2) and torch.equal(s, s2)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("m,k,n,dtype", [
    (1, 64, 8, torch.float32), (127, 192, 136, torch.bfloat16),
    (129, 768, 2304, torch.float32), (300, 3072, 768, torch.bfloat16),
    (257, 4096, 1024, torch.float32),
    # Ragged tiles: M past a 128-row tile, N a multiple of 8 past a
    # 256-column tile, at each K of the int8 forwards, both row dtypes;
    # then more tiles than SMs (several tiles a block of the persistent grid).
    (131, 768, 264, torch.bfloat16), (259, 3072, 776, torch.float32),
    (130, 4096, 1032, torch.bfloat16), (4100, 768, 2304, torch.float32),
    (9000, 1024, 1032, torch.bfloat16)])
def test_int8_gemm_kernel_equals_plain(cuda, bias, m, k, n, dtype):
    from mmer_tpu_torch.ops.quant import (qdot, qdot_int8, qdot_reference,
                                          quantize_weight)

    g = _gen(cuda, m + n)
    x = _quant_rows(cuda, m, k, dtype, m)
    wq, ws = quantize_weight(torch.randn(k, n, generator=g, device=cuda))
    b = torch.randn(n, generator=g, device=cuda) if bias else None
    n0 = qdot_int8.launches
    got = qdot(x.reshape(1, m, k), wq, ws, b)
    assert qdot_int8.launches == n0 + 1
    want = qdot_reference(x.reshape(1, m, k), wq, ws, b)
    torch.cuda.synchronize()
    assert got.shape == (1, m, n) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(got, qdot(x.reshape(1, m, k), wq, ws, b))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("m,k,n", [(1, 64, 8), (130, 192, 24), (300, 1536, 768),
                                   (131, 3072, 264), (4100, 3072, 776)])
def test_int8_gemm_u8_kernel_equals_plain(cuda, bias, m, k, n):
    from mmer_tpu_torch.ops.quant import (qdot_u8, qdot_u8_reference,
                                          quantize_weight, u8_correction)

    g = _gen(cuda, m + k)
    x = torch.randint(0, 256, (m, k), generator=g, device=cuda).to(torch.uint8)
    x[0, :4] = torch.tensor([0, 127, 128, 255], dtype=torch.uint8)
    wq, ws = quantize_weight(torch.randn(k, n, generator=g, device=cuda))
    corr = u8_correction(wq)
    b = torch.randn(n, generator=g, device=cuda) if bias else None
    n0 = qdot_u8.launches
    got = qdot_u8(x, wq, ws, corr, bias=b)
    assert qdot_u8.launches == n0 + 1
    want = qdot_u8_reference(x, wq, ws, corr, bias=b)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, qdot_u8(x, wq, ws, corr, bias=b))


def test_int8_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from mmer_tpu_torch.ops.quant import (qdot, qdot_u8, quantize_weight,
                                          row_quant, u8_correction)

    x = torch.randn(4, 96, device=cuda)
    wq, ws = quantize_weight(torch.randn(96, 16, device=cuda))
    with pytest.raises(ValueError, match="multiple of 64"):
        qdot(x, wq, ws)
    x = torch.randn(4, 64, device=cuda)
    wq, ws = quantize_weight(torch.randn(64, 16, device=cuda))
    with pytest.raises(ValueError, match="K-contiguous"):
        qdot(x, wq.contiguous(), ws)
    with pytest.raises(TypeError):
        row_quant(x.half())
    with pytest.raises(ValueError):
        qdot(x, wq.cpu().t().contiguous().t(), ws.cpu())
    with pytest.raises(ValueError):
        qdot_u8(x.to(torch.uint8), wq, ws, u8_correction(wq).long())
    wq12, ws12 = quantize_weight(torch.randn(64, 12, device=cuda))
    with pytest.raises(ValueError, match="multiple of 8"):
        qdot(x, wq12, ws12)


def test_warmup_leaves_no_build_and_requests_launch_the_kernels(cuda):
    """After ``InferenceEngine.warmup`` at the full default widths (a
    decoded sample replayed) a request builds no kernel library, and the
    three kernels of the request path launch in it; warmup itself launched
    them and left the counters as it found them."""
    from mmer_tpu_torch.ops import _build
    from mmer_tpu_torch.scripts.bench_serving import make_face_frames
    from mmer_tpu_torch.serve.engine import InferenceEngine

    wrappers = {"flash_attention": flash_attention, "fused_ffn": fused_ffn,
                "fused_conv_encoder": fused_conv_encoder}
    engine = InferenceEngine(cuda)
    frames, wave = make_face_frames(96, 5)
    before = {k: w.launches for k, w in wrappers.items()}
    engine.warmup(resolutions=[(300, 256)], sample_frames=(frames, 30.0, wave))
    assert {k: w.launches for k, w in wrappers.items()} == before
    for k in wrappers:
        assert engine.last_warmup["launches"][k] > 0, k
    builds = _build.builds
    frames, wave = make_face_frames(96, 6)
    res = engine.infer_frames(frames, 30.0, wave, explain=True, detect_every=3)
    assert len(res["inference"]) == 3
    assert _build.builds == builds
    for k, w in wrappers.items():
        assert w.launches > before[k], k
