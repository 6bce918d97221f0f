"""WavLM on the port's audio path, at tiny widths on the CPU: its bucket of
a relative position, the port's ``AudioEmbedder.embed_batch`` against the
plain reference ``benchmark/reference/wavlm.py`` in float32 and in bf16,
three faults of the gated position bias that those tolerances fail, the
flash route's refusal, the span and counter, and the int8 encoder's copy
of the bias.  The tests marked ``cuda`` hold the int8 encoder to the
full-precision port on a card, and plant the three faults in the cell
``wavlm-large.long`` at its own sizes and limits:

    python -m pytest -o addopts= -s tests/test_torch_wavlm.py -m cuda

The faults, each a hook ``hook(program, state)`` for ``benchmark.cell.run``
planted in the port's encoder after the benchmark builds it:
``bias_dropped`` (no position bias in any layer), ``gate_one`` (every
layer's gate fixed at 1, the table added ungated) and ``reversed`` (the
table of ``q - k`` where the model takes ``k - q``).

The tiny model keeps WavLM's layout (hidden 64, 4 heads, 2 layers, FFN 128)
with 32 buckets up to 40 frames, so that ~50 frames reach every kind of
bucket (exact, log-spaced, capped); the cell's traffic is cut to one call
of a 0.75 s clip and a 1.05 s clip in 1 s pieces: three pieces padded to 49
frames in four rows, one of them a piece of 2 frames.
"""

import copy
import time

import numpy as np
import pytest
import torch

from benchmark import cell as cells, spec, weights
from benchmark.reference import wavlm as ref_wavlm
from benchmark.run import result_line
from mmer_tpu_torch.config import Wav2Vec2Config, WavLMConfig
from mmer_tpu_torch.models.wav2vec2 import (AudioEmbedder, Wav2Vec2Encoder, init_wav2vec2,
                                            kernel_limits, relative_position_bucket)
from mmer_tpu_torch.models.wav2vec2_quant import (quant_w2v2_apply, quant_w2v2_embed,
                                                  quantize_w2v2_params)
from mmer_tpu_torch.utils import profiling

TINY = dict(hidden_dim=64, num_layers=2, num_heads=4, ffn_dim=128,
            conv_dims=[32] * 7, num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4, chunk_duration_s=1.0,
            num_buckets=32, max_bucket_distance=40)
TRAFFIC = dict(clips_per_call=2, calls=1, seconds=[0.6, 1.2], trace_calls=1)
SEED = 2**31 + 11
REFUSAL = ("flash attention takes no relative position bias, and WavLM's gated "
           "bias would be dropped; the plain route (use_flash_attn=False) computes it")

# Tolerances on a row's relative L2 from the float32 reference, at this
# seed and size:
# - float32: the port pads, masks and batches where the reference embeds each
#   piece alone, so only the order of float32 sums differs (4.0e-7 read;
#   50x room); every fault reads 0.013 or more;
# - bf16: GEMM operands and probabilities rounded to bf16 read 0.0049; the
#   mildest fault, the gate fixed at 1, reads 0.0146 (a mean-pooled,
#   normalised row moves little at 2 layers), so 0.01 lies between them
#   with 2.0x and 1.46x room.
TOLERANCE = {"float32": 2e-5, "bfloat16": 0.01}


def bias_dropped(program, state) -> None:
    program.target.model.position_bias = lambda t, device: None


def gate_one(program, state) -> None:
    for layer in program.target.model.layers:
        layer.position_gate = lambda y, f=layer.position_gate: torch.ones_like(f(y))


def reversed_direction(program, state) -> None:
    enc = program.target.model
    table = enc.position_bias
    enc.position_bias = lambda t, device: table(t, device).transpose(-1, -2)


FAULTS = {"bias_dropped": bias_dropped, "gate_one": gate_one,
          "reversed": reversed_direction}


def tiny_cell(dtype: str) -> spec.Cell:
    c = spec.cell(spec.load(), "wavlm-large.long")
    c.config = copy.deepcopy(c.config)
    c.config["model"].update(TINY, compute_dtype=dtype)
    c.traffic = dict(c.traffic, **TRAFFIC, limits={"worst_rel_l2": TOLERANCE[dtype],
                                                   "bias_rel_l2": TOLERANCE[dtype]})
    return c


def cpu_run(c: spec.Cell, hook=None, traced: bool = False):
    return cells.run(c, SEED, 0.05, traced, torch.device("cpu"), time.perf_counter(),
                     hook=hook)


def tiny_embedder() -> AudioEmbedder:
    m = tiny_cell("float32").config["model"]
    state = weights.make_state(ref_wavlm.param_shapes(m), SEED, torch.device("cpu"))
    cfg = WavLMConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in m.items()})
    return AudioEmbedder(cfg, device="cpu", params=state)


@pytest.mark.parametrize("rel,want", [
    (0, 0), (1, 161), (-1, 1), (79, 239), (-79, 79), (80, 240), (-80, 80),
    (100, 247), (-100, 87), (250, 279), (498, 303), (-498, 143), (799, 319),
    (-800, 159), (2000, 319)])
def test_bucket_of_a_relative_position(rel, want):
    assert relative_position_bucket(torch.tensor([rel]), 320, 800).item() == want
    assert ref_wavlm.bucket(torch.tensor([rel]), 320, 800).item() == want


def test_buckets_at_499_frames():
    pos = torch.arange(499)
    got = relative_position_bucket(pos[None] - pos[:, None], 320, 800)
    assert torch.equal(got, ref_wavlm.bucket(pos[None] - pos[:, None], 320, 800))
    assert (got.unique().numel(), int(got.min()), int(got.max())) == (287, 0, 303)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_matches_the_reference(dtype):
    run = cpu_run(tiny_cell(dtype))
    worst = run.check["worst_rel_l2"][0]
    assert run.check["malformed_rows"][0] == run.check["misrouted_rows"][0] == 0
    assert run.failed == 0 and run.attempted > 0, run.summary
    # bf16 rounding is seen: the port in bf16 is not the float32 program.
    assert worst < TOLERANCE[dtype] and (dtype == "float32" or worst > 1e-4), run.summary


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_breaks_the_tolerance(fault, dtype):
    c = tiny_cell(dtype)
    line = result_line(cpu_run(c, hook=FAULTS[fault]), c, {})
    assert not line["correct"]
    assert line["check"]["worst_rel_l2"]["value"] > TOLERANCE[dtype]


def test_flash_route_is_refused_with_a_sentence():
    assert kernel_limits(WavLMConfig(), use_flash_attn=True) == REFUSAL
    assert kernel_limits(WavLMConfig(), use_flash_attn=False) is None
    assert kernel_limits(Wav2Vec2Config(), use_flash_attn=True) is None
    cfg = WavLMConfig(**{**TINY, "conv_dims": (32,) * 7})
    with pytest.raises(ValueError, match="no relative position bias"):
        Wav2Vec2Encoder(cfg, device="cpu", use_flash_attn=True)
    # Left to follow use_kernels, a WavLM encoder's attention stays plain.
    assert not Wav2Vec2Encoder(cfg, device="cpu").layers[0].use_flash_attn


def test_wav2vec2_layout_is_unchanged_and_wavlm_adds_only_the_bias():
    w2v2 = Wav2Vec2Config(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in TINY.items()
                             if k not in ("num_buckets", "max_bucket_distance")})
    plain = set(Wav2Vec2Encoder(w2v2, device="cpu").state_dict())
    wavlm = set(tiny_embedder().model.state_dict())
    assert "feature_encoder.convs.0.bias" in plain
    assert not any("rel" in k for k in plain)
    assert wavlm == set(ref_wavlm.param_shapes(tiny_cell("float32").config["model"]))
    assert {k for k in plain - wavlm} == {f"feature_encoder.convs.{i}.bias"
                                          for i in range(7)}


def test_default_init_shares_wav2vec2_draws():
    """Without params: the params WavLM shares with Wav2Vec2 are Wav2Vec2's
    seeded draws; E is a unit normal, each κ is 1."""
    shared = {k: tuple(v) if isinstance(v, list) else v for k, v in TINY.items()
              if k not in ("num_buckets", "max_bucket_distance")}
    wavlm = AudioEmbedder(WavLMConfig(**shared, num_buckets=32, max_bucket_distance=40),
                          device="cpu").model.state_dict()
    w2v2 = init_wav2vec2(Wav2Vec2Config(**shared), device="cpu").state_dict()
    assert all(torch.equal(v, w2v2[k]) for k, v in wavlm.items() if k in w2v2)
    assert abs(float(wavlm["layers.0.rel_attn_embed.weight"].std()) - 1) < 0.1
    assert torch.equal(wavlm["layers.1.gru_rel_pos_const"], torch.ones(4))


def test_span_and_counter(monkeypatch):
    """One call traced: the span once a forward, and ``wavlm.bias_bytes`` =
    the (H, T, T) table once plus each layer's (B, H, T) gate, float32; the
    benchmark's reader divides it by the audio seconds."""
    totals: dict = {}
    monkeypatch.setattr(profiling, "counters", totals)
    c = tiny_cell("float32")
    run = cpu_run(c, traced=True)
    m = c.config["model"]
    forwards = run.trace.forwards
    assert len(forwards) == 1 and forwards[0]["rows"] == 4
    h, t, b = m["num_heads"], forwards[0]["frames"], forwards[0]["rows"]
    assert t == 49
    want = 4 * (h * t * t + m["num_layers"] * b * h * t)
    assert totals["wavlm.bias_bytes"] == want
    assert totals["mmer.wavlm.rel_bias"] > 0
    assert run.metrics["bias_mb.wavlm"] == pytest.approx(1e-6 * want / run.trace.useful)
    assert {"mfu.w2v2", "idle_share.w2v2"} <= set(run.metrics)


def test_int8_encoder_keeps_the_gated_bias():
    """The int8 encoder (plain versions) against the float32 port: a few
    per cent a row from int8 rounding; with the bias dropped from both it
    stays so, while the bias itself moves the rows far more."""
    emb = tiny_embedder()
    rs = np.random.RandomState(0)
    waves = torch.from_numpy(rs.standard_normal((2, 16000)).astype(np.float32))
    mask = torch.zeros(2, 49, dtype=torch.bool)
    mask[1, 30:] = True
    model = emb.model
    with torch.inference_mode():
        want = model(waves, mask)
        got = quant_w2v2_apply(quantize_w2v2_params(model), model, waves, mask,
                               use_kernels=False)
        model.position_bias = lambda t, device: None
        unbiased = model(waves, mask)

    def rel(a, b):
        keep = ~mask
        return float((a - b)[keep].norm() / b[keep].norm())

    assert rel(got, want) < 0.05
    assert rel(unbiased, want) > 4 * rel(got, want)


@pytest.mark.cuda
def test_int8_encoder_on_the_card_follows_the_port():
    """WavLM at its published widths, four layers, on the card: the int8
    encoder (``csrc/qdot.cu``, the conv and positional-conv kernels) against
    the bf16 port on the same weights, a few per cent a row as the int8
    control reads on the Wav2Vec2 cells (PERF.md §2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    device = torch.device("cuda", 0)
    m = dict(spec.cell(spec.load(), "wavlm-large.long").config["model"], num_layers=4)
    state = weights.make_state(ref_wavlm.param_shapes(m), SEED, device, torch.bfloat16)
    cfg = WavLMConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in m.items()})
    emb = AudioEmbedder(cfg, device=device, params=state)
    waves = torch.randn(4, 160000, generator=torch.Generator(device=device).manual_seed(3),
                        device=device)
    mask = torch.zeros(4, 499, dtype=torch.bool, device=device)
    mask[1, 300:] = True
    with torch.inference_mode():
        want = emb.embed_rows(waves, mask)
        got = quant_w2v2_embed(quantize_w2v2_params(emb.model), emb.model, waves, mask)
    err = ((got - want).norm(dim=1) / want.norm(dim=1)).max().item()
    assert 1e-4 < err < 0.05, err


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_fails_the_cell_at_full_width(fault, monkeypatch):
    """Each fault planted in ``wavlm-large.long`` at its published widths,
    traffic and limits, one short window: the run is not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchmark.run import CACHES

    for key, path in CACHES.items():
        monkeypatch.setenv(key, str(path))
    c = spec.cell(spec.load(), "wavlm-large.long")
    run = cells.run(c, 2**31 + 4001, 1.0, False, torch.device("cuda", 0),
                    time.perf_counter(), hook=FAULTS[fault])
    print(fault, run.summary)
    assert not result_line(run, c, {})["correct"], run.summary
