"""The positional-conv sublayer (``ops/pos_conv.py``) and its CUDA kernel.

On the CPU: ``pos_conv_residual`` takes its plain version, which must equal,
bit for bit, the sublayer as ``Wav2Vec2Encoder.encode_frames`` computed it
before the kernel existed (``_before`` below: the padded frames zeroed,
``PosConvEmbed``'s arithmetic with its CPU float32 workaround, the float32
residual); the encoder must compute it there; and the grid plan is pinned
at the shapes the main paths give it.

Marked ``cuda`` (skipped without a card; this file imports neither JAX nor
``mmer_tpu``, so ``python -m pytest -o addopts= tests/test_torch_pos_conv.py``
runs on the GPU machine): the kernel against the plain version at the
extraction, serving and ragged shapes, one launch a forward through
``AudioEmbedder.embed_batch``, and GELU rounded once (ROADMAP C4).
"""

import dataclasses
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from mmer_tpu_torch.config import Wav2Vec2Config, torch_dtype
from mmer_tpu_torch.models.layers import dense
from mmer_tpu_torch.models.wav2vec2 import (AudioEmbedder, Wav2Vec2Encoder,
                                            kernel_limits)
from mmer_tpu_torch.ops.fused_blocks import fused_ffn
from mmer_tpu_torch.ops.pos_conv import (pos_conv_limits, pos_conv_plan,
                                         pos_conv_reference, pos_conv_residual)

from torch_threads import few_threads  # noqa: F401

H100_SMS = 132


def _before(x, pad_mask, conv, cfg):
    """The sublayer as ``encode_frames`` and ``PosConvEmbed.forward``
    computed it before ``ops/pos_conv.py``, word for word."""
    if pad_mask is not None:
        x = x.masked_fill(pad_mask[:, :, None], 0.0)
    dt = torch_dtype(cfg)
    xt = x.to(dt).transpose(1, 2)
    w, b = conv.weight.to(dt), conv.bias.to(dt)
    if xt.device.type == "cpu" and dt == torch.bfloat16:
        xt, w = xt.float(), w.float()
    y = F.conv1d(xt, w, padding=conv.padding, groups=conv.groups).to(dt) + b[:, None]
    if cfg.num_conv_pos_embeddings % 2 == 0:
        y = y[:, :, :-1]
    return x + F.gelu(y).transpose(1, 2).float()


def _cfg(d, groups, taps, dtype="bfloat16"):
    return Wav2Vec2Config(hidden_dim=d, num_conv_pos_embedding_groups=groups,
                          num_conv_pos_embeddings=taps, compute_dtype=dtype)


def _inputs(cfg, bsz, t_len, seed, device="cpu", padded_rows=()):
    """Seeded stream, conv params (an ``nn.Conv1d``'s weight and bias, with
    its padding and groups) and a pad mask (B, T): row i keeps a seeded
    number of leading frames, each row of ``padded_rows`` none."""
    g = torch.Generator(device=device).manual_seed(seed)
    d, taps = cfg.hidden_dim, cfg.num_conv_pos_embeddings
    groups = cfg.num_conv_pos_embedding_groups
    conv = SimpleNamespace(
        weight=torch.randn(d, d // groups, taps, generator=g, device=device)
        * (d // groups * taps) ** -0.5,
        bias=0.1 * torch.randn(d, generator=g, device=device),
        padding=(taps // 2,), groups=groups)
    x = torch.randn(bsz, t_len, d, generator=g, device=device)
    keep = torch.randint(1, t_len + 1, (bsz,), generator=g, device=device)
    keep[0] = t_len
    for i in padded_rows:
        keep[i] = 0
    mask = torch.arange(t_len, device=device)[None, :] >= keep[:, None]
    return x, mask, conv


@pytest.mark.parametrize("d,groups,taps,t_len,dtype,masked", [
    (32, 4, 16, 9, "bfloat16", True),    # the tiny test configs' widths
    (24, 3, 5, 8, "bfloat16", False),    # odd taps, even T
    (24, 3, 5, 7, "float32", True),
    (32, 4, 16, 12, "float32", False),
    (1024, 16, 128, 8, "bfloat16", True),     # the published widths at short T
    (1024, 16, 127, 13, "bfloat16", False),
])
def test_the_sublayer_is_the_one_encode_frames_computed_before(d, groups, taps,
                                                               t_len, dtype, masked):
    cfg = _cfg(d, groups, taps, dtype)
    x, mask, conv = _inputs(cfg, 3, t_len, seed=d + taps + t_len, padded_rows=(2,))
    mask = mask if masked else None
    with torch.inference_mode():
        want = _before(x, mask, conv, cfg)
        for fn in (pos_conv_residual, pos_conv_reference):
            got = fn(x, mask, conv.weight, conv.bias, cfg)
            assert got.dtype == torch.float32 and got.shape == x.shape
            assert torch.equal(got, want)
    if masked:
        # A fully padded row is the GELU of the bias alone: its stream and
        # its neighbours' frames are zero (to float32 rounding: PyTorch's
        # vectorised erf on the CPU differs from its scalar one in the last
        # bit).
        want_row = F.gelu(conv.bias.to(torch_dtype(cfg))).float()
        torch.testing.assert_close(want[2], want_row.expand(t_len, d),
                                   rtol=2 ** -20, atol=0)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_encode_frames_runs_the_sublayer(use_kernels):
    """The whole encoder after its conv stack: the projection, the sublayer
    as it was computed before, the layers and the final norm, bit for bit
    (on the CPU both routes take the plain versions)."""
    cfg = Wav2Vec2Config(hidden_dim=32, num_layers=1, num_heads=2, ffn_dim=64,
                         conv_dims=(16, 16), conv_strides=(5, 2),
                         conv_kernels=(10, 3), num_conv_pos_embeddings=16,
                         num_conv_pos_embedding_groups=4)
    torch.manual_seed(0)
    model = Wav2Vec2Encoder(cfg, device="cpu", use_kernels=use_kernels).eval()
    g = torch.Generator().manual_seed(1)
    feats = torch.randn(2, 11, 16, generator=g).bfloat16()
    mask = torch.arange(11)[None, :] >= torch.tensor([[11], [6]])
    with torch.inference_mode():
        got = model.encode_frames(feats, mask)
        x = dense(model.proj_norm(feats), model.proj, torch.bfloat16).float()
        x = _before(x, mask, model.pos_conv.conv, cfg)
        for layer in model.layers:
            x = layer(x, mask)
        want = model.final_norm(x)
    assert torch.equal(got, want)


@pytest.mark.parametrize("batch,frames,plan", [
    (64, 499, (256, 2048)),     # w2v2-large.long: 10 s pieces
    (64, 249, (256, 1024)),     # w2v2-large.extract: the 5 s bucket
    (64, 149, (256, 1024)),     # the prep chain's 3 s bucket
    (1, 149, (128, 32)),        # a 3 s serving request
    (1, 65, (128, 16)),         # a ragged serving request
    (1, 1500, (128, 192)),      # five windows of up to 6 s
    (2, 499, (128, 128)),       # a 10 s and a 2 s piece in one batch
])
def test_plan_at_the_main_paths_shapes(batch, frames, plan):
    assert pos_conv_plan(batch, frames, 16, 128, H100_SMS) == plan


def test_plan_stages_the_fewest_window_rows_among_grids_that_fill_the_card():
    # 129 frames: one 256-frame tile stages 383 rows, two of 128 510.
    assert pos_conv_plan(64, 129, 16, 128, H100_SMS) == (256, 1024)
    # 257 frames: a second 256-frame tile for one frame stages 766 rows,
    # three of 128 765.
    assert pos_conv_plan(64, 257, 16, 128, H100_SMS) == (128, 3072)
    # With few taps the halo costs little and the padding decides.
    assert pos_conv_plan(64, 300, 16, 5, H100_SMS) == (128, 3072)
    assert pos_conv_plan(64, 200, 16, 5, H100_SMS) == (256, 1024)
    assert pos_conv_plan(4, 100, 16, 128, 1) == (128, 64)
    with pytest.raises(ValueError):
        pos_conv_plan(0, 10, 16, 128, H100_SMS)


def test_limits_at_the_default_config_and_beyond():
    assert pos_conv_limits(Wav2Vec2Config()) is None
    assert "groups of 64" in pos_conv_limits(_cfg(1024, 8, 128))
    assert "at most 128 taps" in pos_conv_limits(_cfg(1024, 16, 160))
    assert "bf16 compute dtype" in pos_conv_limits(_cfg(1024, 16, 128, "float32"))
    assert "groups of 64" in kernel_limits(_cfg(1024, 32, 128))
    assert kernel_limits(_cfg(1024, 32, 128), use_kernels=False) is None


def test_the_wrapper_refuses_other_devices_before_any_work():
    cfg = Wav2Vec2Config()
    x = torch.zeros(1, 3, 1024, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pos_conv_residual(x, None, torch.zeros(1024, 64, 128, device="meta"),
                          torch.zeros(1024, device="meta"), cfg)


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


# Kernel against plain version, absolute, on a unit-normal stream whose
# conv outputs are O(1): the two take the same rounding points, and only
# the order of the 8,192 float32 products of an output differs, which can
# flip the bf16 rounding of the conv output (and then of the bias add and of
# the GELU) for an output within a few float32 ulps of a bf16 midpoint: one
# or two bf16 steps of the GELU output, 2^-5 at values in [4, 8).  Such
# flips are rare, hence the tight mean.
CUDA_TOL = (2 ** -4, 2 ** -14)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,frames", [(64, 249), (64, 499), (1, 149),
                                          (1, 1500), (2, 65)])
def test_kernel_matches_plain(cuda, batch, frames):
    cfg = Wav2Vec2Config()
    x, mask, conv = _inputs(cfg, batch, frames, seed=frames, device=cuda,
                            padded_rows=(1,) if batch > 1 else ())
    with torch.inference_mode():
        n0 = pos_conv_residual.launches
        got = pos_conv_residual(x, mask, conv.weight, conv.bias, cfg)
        assert pos_conv_residual.launches == n0 + 1
        again = pos_conv_residual(x, mask, conv.weight, conv.bias, cfg)
        want = pos_conv_reference(x, mask, conv.weight, conv.bias, cfg)
        torch.cuda.synchronize()
    assert pos_conv_residual.last_plan == pos_conv_plan(
        batch, frames, 16, 128, torch.cuda.get_device_properties(0).multi_processor_count)
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    err = (got - want).abs()
    assert float(err.max()) <= CUDA_TOL[0] and float(err.mean()) <= CUDA_TOL[1], \
        (float(err.max()), float(err.mean()))
    # A padded frame's residual is zero: the stream there is exactly the
    # rounded GELU, and no frame past a row's end was written over.
    assert torch.equal(got[mask].to(torch.bfloat16).float(), got[mask])
    assert got.shape == (batch, frames, 1024)


@pytest.mark.cuda
def test_one_launch_a_forward_through_embed_batch(cuda):
    cfg = dataclasses.replace(Wav2Vec2Config(), num_layers=2)
    emb = AudioEmbedder(cfg, device=cuda)
    g = torch.Generator().manual_seed(5)
    calls = [[torch.randn(n, generator=g).numpy() for n in (16000, 40000, 7000)],
             [torch.randn(n, generator=g).numpy() for n in (200_000, 1)]]
    for waves in calls:
        n0, f0 = pos_conv_residual.launches, fused_ffn.launches
        out = emb.embed_batch(waves)
        forwards = (fused_ffn.launches - f0) // cfg.num_layers
        assert forwards == 1 and pos_conv_residual.launches - n0 == forwards
        assert out.shape == (len(waves), 1024)


@pytest.mark.cuda
def test_gelu_is_rounded_once_on_the_card(cuda):
    """ROADMAP C4: on padded frames (every other frame here) the residual is
    zero, so the output is the kernel's rounded GELU itself.  It must be
    bf16(GELU(y)) of the plain version's y, not JAX's op-by-op sequence
    ``0.5 x erfc(-x bf16(sqrt 1/2))`` with each op rounded."""
    cfg = Wav2Vec2Config()
    x, _, conv = _inputs(cfg, 4, 249, seed=7, device=cuda)
    mask = (torch.arange(249, device=cuda) % 2 == 1).expand(4, 249).contiguous()
    bf = torch.bfloat16
    with torch.inference_mode():
        got = pos_conv_residual(x, mask, conv.weight, conv.bias, cfg)[mask]
        xm = x.masked_fill(mask[:, :, None], 0.0)
        y = F.conv1d(xm.to(bf).float().transpose(1, 2), conv.weight.to(bf).float(),
                     padding=64, groups=16).to(bf) + conv.bias.to(bf)[:, None]
        y = y[:, :, :-1].transpose(1, 2)[mask]
        once = F.gelu(y.float()).to(bf).float()
        half = torch.tensor(0.5 ** 0.5, dtype=bf, device=cuda)
        step = torch.special.erfc((-y * half).float()).to(bf)
        each = ((y * step).float() * 0.5).to(bf).float()
    differ = once != each
    assert int(differ.sum()) > 0.05 * once.numel()
    assert float((got != once).float().mean()) < 1e-3
    assert float((got[differ] == each[differ]).float().mean()) < 0.01
