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
from mmer_tpu_torch.ops.conv_pyramid import (conv_encoder_reference,
                                             fused_conv_encoder)
from mmer_tpu_torch.ops.flash_attention import (flash_attention,
                                                reference_attention)
from mmer_tpu_torch.ops.fused_blocks import ffn_reference, fused_ffn

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


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    g = _gen(cuda)
    q = torch.randn(1, 1, 8, 32, generator=g, device=cuda).bfloat16()
    with pytest.raises(ValueError):          # head dim 32
        flash_attention(q, q, q)
    q = torch.randn(1, 1, 8, 64, generator=g, device=cuda)
    with pytest.raises(TypeError):           # f32
        flash_attention(q, q, q)
    x = torch.randn(4, 512, generator=g, device=cuda).bfloat16()
    w = torch.zeros(1024, 512, device=cuda).bfloat16()
    vec = torch.zeros(1024, device=cuda)
    with pytest.raises(ValueError):          # D = 512
        fused_ffn(x, vec[:512], vec[:512], w, vec, w.t().contiguous(), vec[:512])
    cfg = Wav2Vec2Config(compute_dtype="float32")
    with pytest.raises(TypeError):           # f32 compute dtype
        fused_conv_encoder(torch.zeros(1, 1600, device=cuda),
                           *_conv_args(Wav2Vec2Config(), cuda), cfg)
