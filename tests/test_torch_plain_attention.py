"""Wav2Vec2's and WavLM's plain attention (``ops/plain_attention.py``) and
its CUDA kernel.

On the CPU: the kernel's order of operations in plain PyTorch
(``tiled_plain_attention_reference``: key tiles marked from the mask, the
all-padded ones left out, a first pass for the row's max and sum, a second
for the normalised probabilities, rounded, times v) against the torch route
and the JAX package's ``_xla_attention``, at lengths around the 64-key tile
with masks that keep every key, one key and none, and with WavLM's gated
relative position bias against the torch route's (H, T, T) table; the
encoder layer's CPU route, with and without ``use_kernels``, gated or not,
bit for bit the torch ops it ran before the kernel; the kernel's limits and
the wrapper's refusals.

Marked ``cuda`` (skipped without a card; JAX is imported only inside the
CPU test that needs it, so ``python -m pytest -o addopts= -m cuda
tests/test_torch_plain_attention.py`` runs on the GPU machine): the kernel,
gated or not, against the torch route at the extraction and serving shapes,
24 launches a Wav2Vec2 or WavLM forward through ``AudioEmbedder.embed_batch``
and none with ``use_kernels=False``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from mmer_tpu_torch.config import Wav2Vec2Config, WavLMConfig
from mmer_tpu_torch.models.wav2vec2 import (AudioEmbedder, EncoderLayer,
                                            Wav2Vec2Encoder, kernel_limits,
                                            relative_position_bucket)
from mmer_tpu_torch.ops import plain_attention as pa
from mmer_tpu_torch.ops.fused_blocks import fused_ffn
from mmer_tpu_torch.ops.plain_attention import (plain_attention,
                                                plain_attention_limits,
                                                plain_attention_reference,
                                                relative_table, table_form,
                                                tiled_plain_attention_reference)

from torch_threads import few_threads  # noqa: F401

# Kernel (or its order) against the torch route, as fractions of max and
# mean |torch route| (its float32 output): the output is rounded once to
# bf16 (half a step, at most 2^-8 of a value, about 2^-10 on average), and
# where an exp or the sum differs from the torch route's by a float32 ulp a
# probability rounds to the neighbouring bf16 value now and then.  The
# kernel's order read at most 2^-8.4 / 2^-9.4 here.
TOL = (2 ** -7, 2 ** -8)


def _qkv(b, t, heads, seed, device="cpu", lens=None):
    """Seeded bf16 q, k, v (B, T, H·64) and a suffix pad mask from ``lens``
    (every row's keys kept when None)."""
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(b, t, heads * 64, generator=g, device=device)
               .to(torch.bfloat16) for _ in range(3))
    lens = torch.full((b,), t) if lens is None else torch.as_tensor(lens)
    mask = torch.arange(t, device=device)[None, :] >= lens.to(device)[:, None]
    return q, k, v, mask


def _gated(b, t, heads, seed, device="cpu"):
    """A seeded gated term as the kernel takes it: gates in [1, 3) (B, H, T)
    and a unit-normal relative vector (H, 2T − 1), float32."""
    g = torch.Generator(device=device).manual_seed(seed + 1)
    gate = 1 + 2 * torch.rand(b, heads, t, generator=g, device=device)
    return gate, torch.randn(heads, 2 * t - 1, generator=g, device=device)


def _close(got, want):
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got.float()).all()
    assert float(err.max()) <= TOL[0] * float(want.abs().max()), float(err.max())
    assert float(err.mean()) <= TOL[1] * float(want.abs().mean()), float(err.mean())


@pytest.mark.parametrize("t", [1, 63, 64, 65, 130])
def test_kernel_order_matches_the_torch_route_and_jax(t):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    import mmer_tpu.config as jax_config
    from mmer_tpu.models.wav2vec2 import EncoderLayer as JaxEncoderLayer

    heads = 2
    lens = [t, 1, 0, max(t // 2, 1)]        # every key, one, none, half
    q, k, v, mask = _qkv(4, t, heads, seed=t, lens=lens)
    got = tiled_plain_attention_reference(q, k, v, mask, heads)
    want = plain_attention_reference(q, k, v, mask, heads)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _close(got, want)
    cfg = jax_config.Wav2Vec2Config(hidden_dim=heads * 64, num_heads=heads,
                                    compute_dtype="bfloat16")
    to_jax = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
              .reshape(4, t, heads, 64) for x in (q, k, v)]
    attend = jax.jit(lambda *a: JaxEncoderLayer(cfg)._xla_attention(*a, 64))
    jax_out = attend(*to_jax, jnp.asarray(mask.numpy()))
    jax_out = torch.tensor(np.asarray(jax_out, np.float32).reshape(4, t, heads * 64))
    _close(got, jax_out)
    _close(want.bfloat16(), jax_out)


@pytest.mark.parametrize("t", [1, 63, 64, 65, 130])
def test_gated_kernel_order_matches_the_table_route(t):
    """WavLM's term in the kernel's order (each tile's scores plus ``g · r``
    in both passes, before the mask) against the torch route's in-place
    ``addcmul_`` of the (H, T, T) table; rows that keep every key, one key,
    none and half.  Without the term the two differ far beyond the
    tolerance."""
    heads = 2
    q, k, v, mask = _qkv(4, t, heads, seed=t, lens=[t, 1, 0, max(t // 2, 1)])
    gated = _gated(4, t, heads, seed=t)
    got = tiled_plain_attention_reference(q, k, v, mask, heads, gated)
    want = plain_attention_reference(q, k, v, mask, heads, table_form(gated))
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _close(got, want)
    if t > 1:
        plain = tiled_plain_attention_reference(q, k, v, mask, heads)
        assert float((plain.float() - want).abs().max()) > 8 * TOL[0] * float(want.abs().max())


def test_a_row_with_every_key_padded_is_the_mean_of_its_values():
    """Every score of such a row is −1e9 + s, which rounds to −1e9 in float32
    for |s| < 32: the probabilities are uniform and the row is the mean of
    all T values, in the kernel's order as on the torch route."""
    q, k, v, mask = _qkv(2, 70, 2, seed=3, lens=[70, 0])
    got = tiled_plain_attention_reference(q, k, v, mask, 2)[1].float()
    mean = v[1].float().mean(0, keepdim=True).expand(70, -1)
    assert float((got - mean).abs().max()) <= 2 ** -8 * float(mean.abs().max())
    want = plain_attention_reference(q, k, v, mask, 2)[1]
    assert float((want - mean).abs().max()) <= 2 ** -8 * float(mean.abs().max())


def _before(layer, yd, pad_mask):
    """``EncoderLayer._attention``'s plain route as it was before the
    kernel, word for word."""
    cfg = layer.cfg
    dt = torch.bfloat16
    b, t, d = yd.shape
    h = cfg.num_heads
    hd = d // h
    q, k, v = (y.reshape(b, t, h, hd).transpose(1, 2)
               for y in layer.project_qkv(yd))
    q, k, v = q.float(), k.float(), v.float()
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
    if pad_mask is not None:
        scores = scores + pad_mask[:, None, None, :].float() * -1e9
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(dt).float(), v)
    return out.transpose(1, 2).reshape(b, t, d)


@pytest.mark.parametrize("use_kernels,fused", [(True, False), (False, False),
                                               (True, True), (False, True)])
def test_the_cpu_route_is_the_torch_ops_it_was(use_kernels, fused):
    cfg = Wav2Vec2Config(hidden_dim=128, num_heads=2, ffn_dim=256)
    torch.manual_seed(0)
    layer = EncoderLayer(cfg, device="cpu", use_kernels=use_kernels,
                         use_fused_qkv=fused).eval()
    g = torch.Generator().manual_seed(1)
    yd = torch.randn(3, 21, 128, generator=g).bfloat16()
    mask = torch.arange(21)[None, :] >= torch.tensor([[21], [5], [0]])
    with torch.inference_mode():
        for m in (mask, None):
            got = layer._attention(yd, m)
            assert got.dtype == torch.float32
            assert torch.equal(got, _before(layer, yd, m))


def _before_gated(layer, yd, pad_mask, gate, table):
    """A WavLM layer's torch route as it was before the kernel took the
    gated term, word for word: q, k, v converted to float32, the (B, H, T,
    1) gate times the (H, T, T) table added in place, then the mask."""
    b, t, d = yd.shape
    h = layer.cfg.num_heads
    q, k, v = (y.float().reshape(b, t, h, d // h).transpose(1, 2)
               for y in layer.project_qkv(yd))
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d // h)
    scores.addcmul_(gate.unsqueeze(-1), table)
    if pad_mask is not None:
        scores = scores + pad_mask[:, None, None, :].float() * -1e9
    out = torch.matmul(torch.softmax(scores, dim=-1).to(torch.bfloat16).float(), v)
    return out.transpose(1, 2).reshape(b, t, d)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_the_gated_cpu_route_is_the_torch_ops_it_was(use_kernels):
    """A WavLM layer on the CPU: the relative vector its layer 0 builds,
    expanded, is the table it built before, and the route, with or without
    ``use_kernels``, is the torch ops it ran before, bit for bit."""
    cfg = WavLMConfig(hidden_dim=128, num_heads=2, ffn_dim=256, num_buckets=32,
                      max_bucket_distance=40)
    torch.manual_seed(0)
    layer = EncoderLayer(cfg, device="cpu", use_kernels=use_kernels, rel_embed=True).eval()
    g = torch.Generator().manual_seed(1)
    y = torch.randn(3, 50, 128, generator=g)
    mask = torch.arange(50)[None, :] >= torch.tensor([[50], [5], [0]])
    pos = torch.arange(50)
    table = layer.rel_attn_embed.weight.t()[:, relative_position_bucket(
        pos[None, :] - pos[:, None], 32, 40)]
    with torch.inference_mode():
        rel = layer.position_bias(50, torch.device("cpu"))
        gate = layer.position_gate(y)
        assert rel.shape == (2, 99) and gate.shape == (3, 2, 50)
        assert torch.equal(relative_table(rel), table)
        for m in (mask, None):
            got = layer._attention(y.bfloat16(), m, (gate, rel))
            assert got.dtype == torch.float32
            assert torch.equal(got, _before_gated(layer, y.bfloat16(), m, gate, table))


def test_limits_name_the_head_dim_and_the_dtype():
    assert plain_attention_limits(Wav2Vec2Config()) is None
    wide = Wav2Vec2Config(num_heads=8)
    assert "plain attention kernel takes head dim 64, got 128" in plain_attention_limits(wide)
    assert "bf16 compute dtype" in plain_attention_limits(
        Wav2Vec2Config(compute_dtype="float32"))
    assert "plain attention kernel takes head dim 64" in kernel_limits(wide)
    # WavLM's gated layers launch it too.
    assert "plain attention kernel takes head dim 64, got 128" in kernel_limits(
        WavLMConfig(num_heads=8))
    # Not on the routes that never launch it: flash attention and the plain
    # path.
    assert "plain attention" not in kernel_limits(wide, use_flash_attn=True)
    assert kernel_limits(wide, use_kernels=False) is None
    with pytest.raises(ValueError, match="Wav2Vec2Encoder: the plain attention "
                                         "kernel takes head dim 64, got 128"):
        Wav2Vec2Encoder(wide, device="cuda", use_flash_attn=False)
    Wav2Vec2Encoder(dataclasses.replace(wide, num_layers=1), device="cpu",
                    use_flash_attn=False)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(1, 3, 128, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        plain_attention(q, q, q, None, 2)
    x = torch.zeros(2, 5, 3 * 128, dtype=torch.bfloat16)
    q, k, v = x.split(128, dim=-1)
    assert pa._check(q, k, v, None, 2) == 3 * 128      # the fused slices
    with pytest.raises(ValueError, match="head dim 64"):
        pa._check(q, k, v, None, 4)
    with pytest.raises(ValueError, match="row stride"):
        pa._check(q, k.contiguous(), v, None, 2)
    with pytest.raises(TypeError, match="bf16"):
        pa._check(q.float(), k.float(), v.float(), None, 2)
    with pytest.raises(ValueError, match="pad_mask"):
        pa._check(q, k, v, torch.zeros(2, 5), 2)
    gate, r = torch.zeros(2, 2, 5), torch.zeros(2, 9)
    pa._check_gated((gate, r), q, 2)
    for bad in ((gate.double(), r), (gate, torch.zeros(2, 10)),
                (gate[:, :1], r), (gate.transpose(0, 1).contiguous().transpose(0, 1), r)):
        with pytest.raises(ValueError, match="gated must be"):
            pa._check_gated(bad, q, 2)


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,frames,gated", [
    (64, 249, False), (64, 499, False), (1, 149, False), (1, 1500, False),
    (2, 499, False), (64, 499, True), (64, 249, True), (2, 499, True)])
def test_kernel_matches_the_torch_route(cuda, batch, frames, gated):
    g = torch.Generator().manual_seed(frames)
    lens = torch.randint(1, frames + 1, (batch,), generator=g)
    lens[0] = frames
    if batch > 1:
        lens[-1] = 0                            # a row with every key padded
    q, k, v, mask = _qkv(batch, frames, 16, seed=frames, device=cuda, lens=lens)
    bias = _gated(batch, frames, 16, seed=frames, device=cuda) if gated else None
    with torch.inference_mode():
        n0 = plain_attention.launches
        got = plain_attention(q, k, v, mask, 16, bias)
        assert plain_attention.launches == n0 + 1
        again = plain_attention(q, k, v, mask, 16, bias)
        want = plain_attention_reference(q, k, v, mask, 16, table_form(bias))
        torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.equal(got, again)
    _close(got, want)


def _forwards_and_launches(emb, calls, layers):
    out = []
    for waves in calls:
        n0, f0 = plain_attention.launches, fused_ffn.launches
        emb.embed_batch(waves)
        out.append(((fused_ffn.launches - f0) // layers, plain_attention.launches - n0))
    return out


def _calls():
    g = torch.Generator().manual_seed(5)
    return [[torch.randn(n, generator=g).numpy() for n in (16000, 40000, 7000)],
            [torch.randn(n, generator=g).numpy() for n in (200_000, 1)]]


@pytest.mark.cuda
@pytest.mark.parametrize("config", [Wav2Vec2Config, WavLMConfig])
def test_24_launches_a_wav2vec2_forward_through_embed_batch(cuda, config):
    """One launch a layer, Wav2Vec2's and WavLM's gated layers alike."""
    cfg = config()
    emb = AudioEmbedder(cfg, device=cuda)
    for forwards, launches in _forwards_and_launches(emb, _calls(), cfg.num_layers):
        assert forwards == 1 and launches == cfg.num_layers == 24


@pytest.mark.cuda
def test_the_plain_path_launches_none(cuda):
    cfg = dataclasses.replace(Wav2Vec2Config(), num_layers=2)
    emb = AudioEmbedder(cfg, device=cuda, use_kernels=False)
    for forwards, launches in _forwards_and_launches(emb, _calls(), cfg.num_layers):
        assert launches == 0 and forwards == 0
