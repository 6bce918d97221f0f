"""The port's spans and counters (``mmer_tpu_torch/utils/profiling.py``) in
its two extraction entries: nothing records without a profiler; under one,
``embed_batch`` and ``embed_chunks`` mark their stages in order, the frame
counters hold the padding arithmetic, the weight casts are counted, and the
rows do not change.  Tiny configurations on the CPU."""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mmer_tpu_torch.config import ViViTConfig, Wav2Vec2Config
from mmer_tpu_torch.core.buckets import batch_bucket
from mmer_tpu_torch.models.vivit import ViViTFeatureExtractor
from mmer_tpu_torch.models.wav2vec2 import (AudioEmbedder, Wav2Vec2Encoder,
                                            feat_extract_output_length)
from mmer_tpu_torch.preprocess.extract import VideoFeatureExtractor
from mmer_tpu_torch.utils import profiling

from torch_threads import few_threads  # noqa: F401

CPU = torch.device("cpu")
SR = 16000
TINY_V = dict(image_size=(32, 32), patch_size=(16, 16), num_frames=8,
              tubelet_size=4, dim=64, depth=2, heads=2, dim_head=32, mlp_dim=128)
TINY_A = dict(hidden_dim=64, num_layers=2, num_heads=2, ffn_dim=128,
              conv_dims=(32,) * 7, num_conv_pos_embeddings=16,
              num_conv_pos_embedding_groups=4, chunk_duration_s=1.0)
# Clips of 0.5, 1.7, 0.3 and 1.2 s: six pieces of 1 s at most, padded to
# 1 s and to batch_bucket(6) = 8 rows, two of them repeats.
CLIP_SECONDS = (0.5, 1.7, 0.3, 1.2)


def _audio(dtype: str = "float32") -> AudioEmbedder:
    cfg = Wav2Vec2Config(**TINY_A, compute_dtype=dtype)
    torch.manual_seed(0)
    state = Wav2Vec2Encoder(cfg, device=CPU, use_kernels=False).state_dict()
    return AudioEmbedder(cfg, device=CPU, params=state)


def _video(dtype: str = "float32", device_batch: int = 2) -> VideoFeatureExtractor:
    cfg = ViViTConfig(**TINY_V, compute_dtype=dtype)
    torch.manual_seed(0)
    state = ViViTFeatureExtractor(cfg, device=CPU, use_kernels=False).state_dict()
    return VideoFeatureExtractor(cfg, device=CPU, device_batch=device_batch,
                                 params=state)


def _clips() -> list:
    rng = np.random.default_rng(3)
    return [rng.standard_normal(int(s * SR)).astype(np.float32) for s in CLIP_SECONDS]


def _chunks(n: int) -> np.ndarray:
    rng = np.random.default_rng(4)
    return rng.integers(0, 256, (n, 8, 32, 32, 3), dtype=np.uint8)


def _traced(fn):
    """``fn()`` under a CPU profiler → (its result, the program's spans as
    (name, start, end) in start order, the counters' differences)."""
    before = dict(profiling.counters)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.name.startswith("mmer.")),
                   key=lambda s: s[1])
    moved = {k: v - before.get(k, 0) for k, v in profiling.counters.items()}
    return out, spans, moved


def _disjoint(spans) -> bool:
    return all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))


def test_recording_follows_the_profiler():
    assert not profiling.recording()
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.recording()
    assert not profiling.recording()


def test_without_a_profiler_nothing_records(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    emb, ex = _audio("bfloat16"), _video("bfloat16")
    before = dict(profiling.counters)
    emb.embed_batch(_clips())
    ex.embed_chunks(_chunks(3))
    ex.embed_chunks(_chunks(3), pipeline=True)
    assert profiling.counters == before
    # ``into`` times the span all the same.
    timings = {"audio": 0.0}
    with profiling.span("mmer.serve.audio", into=timings):
        emb.embed_batch(_clips()[:1])
    assert timings["audio"] > 0


def test_embed_batch_marks_its_stages_in_order():
    emb = _audio()
    _, spans, moved = _traced(lambda: emb.embed_batch(_clips()))
    names = [n for n, _, _ in spans]
    assert names == ["mmer.w2v2." + s for s in ("normalise", "pad", "pad", "upload",
                                                 "forward", "fetch", "merge")]
    assert _disjoint(spans)
    # Each span's seconds are totalled under its name, within its range.
    for name in set(names):
        traced_s = sum(e - s for n, s, e in spans if n == name) / 1e6
        assert 0 < moved[name] <= traced_s + 1e-3


@pytest.mark.parametrize("pipeline", [False, True])
def test_embed_chunks_marks_each_block(pipeline):
    ex = _video(device_batch=2)
    _, spans, _ = _traced(lambda: ex.embed_chunks(_chunks(5), pipeline=pipeline))
    names = [n.rsplit(".", 1)[-1] for n, _, _ in spans]
    assert {n: names.count(n) for n in set(names)} == \
        {"stage": 3, "upload": 3, "forward": 3, "fetch": 3}
    if not pipeline:
        assert names == ["stage", "upload", "forward", "fetch"] * 3
    else:
        # Block i's rows are fetched after block i+1's forward is enqueued.
        assert names == ["stage", "upload", "forward"] * 2 + ["fetch"] \
            + ["stage", "upload", "forward", "fetch", "fetch"]
    assert all(n.startswith("mmer.vivit.") for n, _, _ in spans)
    assert _disjoint(spans)


def test_frame_counters_hold_the_padding_arithmetic():
    emb = _audio()
    _, _, moved = _traced(lambda: emb.embed_batch(_clips()))
    cfg, chunk = emb.cfg, SR
    pieces = [min(chunk, int(s * SR) - p) for s in CLIP_SECONDS
              for p in range(0, int(s * SR), chunk)]
    assert len(pieces) == 6 and batch_bucket(6) == 8
    t_out = feat_extract_output_length(cfg, SR)
    assert moved["w2v2.frames_computed"] == 8 * t_out
    assert moved["w2v2.frames_useful"] == sum(feat_extract_output_length(cfg, n)
                                              for n in pieces)
    assert moved["w2v2.frames_useful"] < moved["w2v2.frames_computed"]


# Parameters a forward keeps in float32: the LayerNorms', the Wav2Vec2 conv
# biases (the conv kernel takes them in float32) and the ViViT FFN biases.
KEPT = {"wav2vec2": re.compile(r"norm|convs\.\d+\.bias"),
        "vivit": re.compile(r"norm|ffn_(in|out)\.bias")}


def _cast_params(model: torch.nn.Module, kind: str) -> int:
    """Elements of the parameters a forward casts to the compute dtype."""
    return sum(p.numel() for name, p in model.named_parameters()
               if not KEPT[kind].search(name))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_weight_casts_are_counted(dtype):
    emb, ex = _audio(dtype), _video(dtype, device_batch=2)
    _, _, audio = _traced(lambda: emb.embed_batch(_clips()))
    _, _, video = _traced(lambda: ex.embed_chunks(_chunks(3)))    # two forwards
    if dtype == "float32":
        assert audio["weights.cast_bytes"] == 0 and video["weights.cast_bytes"] == 0
        return
    assert audio["weights.cast_bytes"] == 6 * _cast_params(emb.model, "wav2vec2")
    assert video["weights.cast_bytes"] == 2 * 6 * _cast_params(ex.model, "vivit")


def test_rows_are_the_same_with_tracing_on():
    emb, ex = _audio("bfloat16"), _video("bfloat16")
    clips, chunks = _clips(), _chunks(3)
    plain = emb.embed_batch(clips), ex.embed_chunks(chunks)
    traced, _, _ = _traced(lambda: (emb.embed_batch(clips), ex.embed_chunks(chunks)))
    for a, b in zip(plain, traced):
        assert np.array_equal(a, b)
