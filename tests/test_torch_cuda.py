"""The hand-written CUDA kernels against their plain PyTorch versions, on a
GPU.

Every test here needs a CUDA device and skips without one; the file imports
neither JAX nor ``mmer_tpu``, so it runs on a machine that has only PyTorch
and the CUDA toolkit:

    python -m pytest -o addopts= tests/test_torch_cuda.py

(``-o addopts=`` drops the CPU-mesh plugin the repository's pytest settings
load, which a GPU machine without JAX does not need.)

Shapes cover the ragged edges the main path's shapes do not: sequences and
token counts that are not multiples of the kernels' 64- and 32-row tiles,
and conv stacks whose last layers have fewer frames than one block.
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
                                             k3_ln_gelu_reference)
from mmer_tpu_torch.ops.flash_attention import (flash_attention,
                                                flash_attention_varlen,
                                                reference_attention,
                                                reference_attention_varlen)
from mmer_tpu_torch.ops.attention_variants import (MODES, attention_variant,
                                                   attention_variant_reference)
from mmer_tpu_torch.ops.fused_blocks import (ffn_reference, fused_ffn,
                                             fused_ln_matmul,
                                             ln_matmul_reference)

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
    """Rows not a multiple of the 32-row tile, batch > 1, t_pad above the
    operand's rows (the pad row comes from zeros) and below them."""
    x, w, vecs = _layer_operands(cuda, batch, rows, kdim)
    n0 = conv_pyramid._call_gemm.launches
    got = conv_pyramid._call_gemm(x, w, *vecs, t_pad)
    assert conv_pyramid._call_gemm.launches == n0 + 1
    assert got.shape == (batch, t_pad, 512) and got.dtype == torch.bfloat16
    mx, mean = _err(got, gemm_ln_gelu_reference(x, w, *vecs, t_pad))
    # One layer: a flipped bf16 rounding of the conv sum moves the output by
    # at most a few bf16 steps of an O(1) value.
    assert mx <= 0.0625 and mean <= 1e-3, (mx, mean)


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
