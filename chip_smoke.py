#!/usr/bin/env python3
"""Smoke run of the PyTorch port's clip path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. device: print the card's name and power limit (``nvidia-smi``); exit
   non-zero when CUDA is unavailable -- there is no CPU fallback.
2. build: compile every kernel under ``mmer_tpu_torch/csrc`` with nvcc.
3. kernels: each kernel against its plain PyTorch version, both on the
   card, at the main path's shapes: max / mean absolute error against the
   tolerances in ``TOLERANCES`` and both times (CUDA events, after
   warm-up).
4. main path: ``InferenceEngine`` at the full default configs with seeded
   port-native weights serves three requests (``predict_chunks`` on a
   3-chunk clip with 3.2 s of audio and on a 1-chunk clip with 12 s of
   audio, ``infer_sequence`` on 5 subchunks at 30 fps).  Probabilities must
   be finite and sum to 1, and every kernel's launch count must rise by
   exactly what the requests imply.  The same requests then run on the
   plain path on the card, and their embeddings are also computed on an
   f32 plain path: audio embeddings of the kernel and plain paths must
   agree within 0.5 % relative L2 (the extractor feature-noise contract);
   video embeddings of the kernel path must be no further from the f32
   path than the plain bf16 path's (see ``VIDEO_F32_FACTOR``).

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Kernel vs plain version, both on the card, same inputs: bounds on the max
# and mean absolute error, absolute, or for attention fractions of max and
# mean |plain| (a bf16 ulp scales with the output).
TOLERANCES = {
    # The kernel rounds exp(s - running max) to bf16, the plain version the
    # normalised p: about a third of a bf16 ulp apart on average (the bound
    # of tests/test_torch_cuda.py).  Checked twice: on unit-normal q, k, v,
    # and with q and k tripled (scores of std ~9), where a kernel that
    # rounds the scores to bf16 errs by 2^-4 of max |plain|.
    "flash_attention": (2 ** -6, 2 ** -7),
    # bf16 stream of size ~1-8: accumulation order can flip the final bf16
    # rounding, one ulp is 0.0625 at |x| in [8, 16).
    "fused_ffn": (0.0625, 1e-3),
    # f32 stream: only bf16 roundings of the hidden units can flip.
    "fused_ffn_w2v2": (2e-3, 1e-4),
    # seven bf16 layers; a flipped rounding propagates through LayerNorm
    # into the next layer.  The repository's own bound for this comparison
    # (tests/test_conv_pyramid.py, Pallas kernel vs XLA module in bf16).
    "fused_conv_encoder": (0.06, 5e-3),
}
RELATIVE = {"flash_attention"}
# The conv kernel's mean error against the f32 path may exceed the plain
# bf16 version's by at most this factor.
CONV_F32_FACTOR = 1.25
# README "Extractor-numerics contract": embeddings may move < 0.5 % rel-L2.
# It binds the audio path (an f32 residual stream).  The ViViT keeps a bf16
# residual stream, whose own rounding puts any two bf16 implementations
# ~0.8 % apart however their sums are ordered, the JAX package's own XLA and
# Pallas routes included (PERF.md, Findings); there the kernel path must
# instead be no further from an f32 path than the plain bf16 path is, within
# VIDEO_F32_FACTOR.  Sound kernels read at most 1.024 on these inputs; an FFN
# that accumulates its hidden chunks in bf16 reads 1.07-1.11.
EMBED_REL_L2 = 0.005
VIDEO_F32_FACTOR = 1.05
SOURCES = {
    "flash_attention": ("mmer_tpu_torch/csrc/attention.cu",
                        "mmer_tpu/ops/flash_attention.py:51"),
    "fused_ffn": ("mmer_tpu_torch/csrc/ffn.cu",
                  "mmer_tpu/ops/fused_blocks.py:135"),
    "fused_conv_encoder": ("mmer_tpu_torch/csrc/conv_encoder.cu",
                           "mmer_tpu/ops/conv_pyramid.py:278"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def device_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable ({e})"
    return out or "nvidia-smi printed nothing"


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build_kernels() -> None:
    from mmer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    per = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s wall "
        + ", ".join(f"{k} {v:.2f} s" for k, v in per.items()))
    for name in _build.KERNELS:
        for line in _build.build_report(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}] {line.strip()}")


def _compare(name: str, got, want, key: str | None = None) -> dict:
    import torch

    err = (got.float() - want.float()).abs()
    mx, mean = float(err.max()), float(err.mean())
    tol_max, tol_mean = TOLERANCES[key or name]
    if (key or name) in RELATIVE:
        size = want.float().abs()
        tol_max, tol_mean = tol_max * float(size.max()), tol_mean * float(size.mean())
    ok = bool(torch.isfinite(got.float()).all()) and mx <= tol_max \
        and mean <= tol_mean
    log(f"kernel {key or name}: max_abs_err {mx:.3e} (tol {tol_max:.3e}) "
        f"mean_abs_err {mean:.3e} (tol {tol_mean:.3e}) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{key or name} disagrees with its plain version")
    return {"max_abs_err": mx, "mean_abs_err": mean}


def check_kernels(dev) -> dict:
    """Each kernel vs its plain version at the main path's shapes."""
    import torch

    from mmer_tpu_torch.config import Wav2Vec2Config
    from mmer_tpu_torch.models.wav2vec2 import feat_extract_output_length
    from mmer_tpu_torch.ops.conv_pyramid import (conv_encoder_reference,
                                                 fused_conv_encoder)
    from mmer_tpu_torch.ops.flash_attention import (flash_attention,
                                                    reference_attention)
    from mmer_tpu_torch.ops.fused_blocks import ffn_reference, fused_ffn

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    bf = torch.bfloat16
    res = {}

    # ViViT attention: (8 chunks, 12 heads, 1569 tokens, 64).
    q, k, v = (randn(8, 12, 1569, 64, dtype=bf) for _ in range(3))
    got = flash_attention(q, k, v)
    want = reference_attention(q, k, v)
    torch.cuda.synchronize()
    r = _compare("flash_attention", got, want)
    r["ms"] = cuda_ms(lambda: flash_attention(q, k, v), 20)
    r["plain_ms"] = cuda_ms(lambda: reference_attention(q, k, v), 5)
    r["shape"] = "q,k,v (8,12,1569,64) bf16"
    res["flash_attention"] = r
    q, k = 3 * q, 3 * k
    r2 = _compare("flash_attention", flash_attention(q, k, v),
                  reference_attention(q, k, v))
    r.update(max_abs_err_sharp=r2["max_abs_err"],
             mean_abs_err_sharp=r2["mean_abs_err"])
    del q, k, v, got, want
    torch.cuda.synchronize()

    def ffn_args(tokens_shape, d, m, x_dtype, bias_dtype):
        return (randn(*tokens_shape, d, dtype=x_dtype),
                1.0 + randn(d, std=0.1), randn(d, std=0.1),
                randn(m, d, std=d ** -0.5, dtype=bf),
                randn(m, std=0.1, dtype=bias_dtype),
                randn(d, m, std=m ** -0.5, dtype=bf),
                randn(d, std=0.1, dtype=bias_dtype))

    # ViViT FFN: bf16 stream (8, 1569, 768), f32 LN params and biases.
    args = ffn_args((8, 1569), 768, 3072, bf, torch.float32)
    got = fused_ffn(*args)
    want = ffn_reference(*args)
    torch.cuda.synchronize()
    r = _compare("fused_ffn", got, want)
    r["ms"] = cuda_ms(lambda: fused_ffn(*args), 20)
    r["plain_ms"] = cuda_ms(lambda: ffn_reference(*args), 5)
    r["shape"] = "x (8,1569,768) bf16, M 3072"
    # W2V2 FFN: f32 stream over bf16 weights and biases, a 3 s clip.
    t3 = feat_extract_output_length(Wav2Vec2Config(), 48000)
    args = ffn_args((1, t3), 1024, 4096, torch.float32, bf)
    got = fused_ffn(*args)
    want = ffn_reference(*args)
    torch.cuda.synchronize()
    r2 = _compare("fused_ffn", got, want, key="fused_ffn_w2v2")
    r.update(max_abs_err_w2v2=r2["max_abs_err"],
             mean_abs_err_w2v2=r2["mean_abs_err"],
             ms_w2v2=cuda_ms(lambda: fused_ffn(*args), 50),
             plain_ms_w2v2=cuda_ms(lambda: ffn_reference(*args), 20),
             shape_w2v2=f"x (1,{t3},1024) f32, M 4096")
    res["fused_ffn"] = r
    del args, got, want

    # Conv feature encoder on (4, 48000) f32.
    cfg = Wav2Vec2Config()
    wave = randn(4, 48000)
    c_in, layer = 1, []
    for dim, kk in zip(cfg.conv_dims, cfg.conv_kernels):
        layer.append((randn(dim, c_in, kk, std=(kk * c_in) ** -0.5),
                      randn(dim, std=0.1), 1.0 + randn(dim, std=0.1),
                      randn(dim, std=0.1)))
        c_in = dim
    conv_args = [list(t) for t in zip(*layer)]
    got = fused_conv_encoder(wave, *conv_args, cfg)
    want = conv_encoder_reference(wave, *conv_args, cfg)
    torch.cuda.synchronize()
    if got.shape != (4, feat_extract_output_length(cfg, 48000), 512):
        raise AssertionError(f"fused_conv_encoder shape {tuple(got.shape)}")
    r = _compare("fused_conv_encoder", got, want)
    exact = conv_encoder_reference(
        wave, *conv_args, dataclasses.replace(cfg, compute_dtype="float32"))
    e_kernel = float((got.float() - exact).abs().mean())
    e_plain = float((want.float() - exact).abs().mean())
    log(f"kernel fused_conv_encoder vs the f32 path: mean abs err {e_kernel:.3e}"
        f", plain bf16 version {e_plain:.3e}")
    if e_kernel > CONV_F32_FACTOR * e_plain:
        raise AssertionError("fused_conv_encoder is further from the f32 path "
                             "than its plain version")
    del exact
    r["ms"] = cuda_ms(lambda: fused_conv_encoder(wave, *conv_args, cfg), 20)
    r["plain_ms"] = cuda_ms(
        lambda: conv_encoder_reference(wave, *conv_args, cfg), 5)
    r["shape"] = "wave (4,48000) f32 -> (4,149,512) bf16"
    res["fused_conv_encoder"] = r
    for name, r in res.items():
        log(f"time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
            f"ms ({r['shape']})")
        if "ms_w2v2" in r:
            log(f"time {name}: kernel {r['ms_w2v2']:.4f} ms, plain "
                f"{r['plain_ms_w2v2']:.4f} ms ({r['shape_w2v2']})")
    return res


def main() -> int:
    log(f"device: {device_line()}")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import mmer_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import mmer_tpu_torch ({e}); run from the "
              "repository root", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    build_kernels()
    kernels = check_kernels(dev)
    launches = run_main_path(dev)
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": launches[name],
         **{k: v for k, v in r.items() if not k.startswith("shape")}}
        for name, r in kernels.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _rel_l2(a, b) -> float:
    import numpy as np

    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _requests(rng):
    """The main path's requests, made from a seed: (name, entry point,
    arguments).  Each makes one Wav2Vec2 forward (its audio pieces go in one
    batch) and one ViViT forward per device batch of chunks."""
    import numpy as np

    def clip(n):
        return rng.integers(0, 256, size=(n, 32, 224, 224, 3), dtype=np.uint8)

    def audio(seconds):
        return (rng.normal(size=(int(seconds * 16000),)) * 0.1).astype(np.float32)

    return [
        ("predict_chunks 3 chunks + 3.2 s audio", "predict_chunks",
         (clip(3), audio(3.2))),
        ("predict_chunks 1 chunk + 12 s audio (split at 10 s)", "predict_chunks",
         (clip(1), audio(12.0))),
        ("infer_sequence 5 subchunks @ 30 fps, 5 windows", "infer_sequence",
         (clip(5), list(range(160)), audio(6.0), 30.0)),
    ]


def run_main_path(dev) -> dict:
    """Serve the requests through InferenceEngine; return the launch counts
    of the measured pass."""
    import numpy as np
    import torch

    from mmer_tpu_torch.config import ViViTConfig, Wav2Vec2Config
    from mmer_tpu_torch.models.wav2vec2 import AudioEmbedder
    from mmer_tpu_torch.ops.conv_pyramid import fused_conv_encoder
    from mmer_tpu_torch.ops.flash_attention import flash_attention
    from mmer_tpu_torch.ops.fused_blocks import fused_ffn
    from mmer_tpu_torch.preprocess.extract import VideoFeatureExtractor
    from mmer_tpu_torch.serve.engine import InferenceEngine

    wrappers = {"flash_attention": flash_attention, "fused_ffn": fused_ffn,
                "fused_conv_encoder": fused_conv_encoder}
    vcfg, wcfg = ViViTConfig(), Wav2Vec2Config()
    engine = InferenceEngine(dev)
    t0 = time.perf_counter()
    _ = engine.video_extractor, engine.audio_embedder, engine.fusion
    torch.cuda.synchronize()
    log(f"main path: engine members built in {time.perf_counter() - t0:.2f} s "
        f"(seeded ViViT-B, Wav2Vec2-large, fusion)")
    requests = _requests(np.random.default_rng(0))

    def serve(eng, label):
        out = []
        for name, entry, args in requests:
            t = time.perf_counter()
            res = getattr(eng, entry)(*args)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            probs = np.asarray(res["probabilities"], np.float64)
            if not (np.isfinite(probs).all()
                    and np.allclose(probs.sum(axis=-1), 1.0, atol=1e-4)):
                raise AssertionError(f"{name}: probabilities not finite or not "
                                     f"normalised: {probs}")
            log(f"request [{label}] {name}: {ms:.2f} ms, probabilities "
                f"{np.round(probs, 4).tolist()}")
            out.append(probs)
        return out

    serve(engine, "first")
    torch.cuda.reset_peak_memory_stats(dev)
    for w in wrappers.values():
        w.launches = 0
    kernel_probs = serve(engine, "warm")
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"peak device memory (warm pass): "
        f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")

    bs = engine.video_extractor.device_batch
    vivit_batches = sum(-(-len(args[0]) // bs) for _, _, args in requests)
    w2v2_forwards = len(requests)
    expected = {
        "flash_attention": vivit_batches * vcfg.depth,
        "fused_ffn": vivit_batches * vcfg.depth + w2v2_forwards * wcfg.num_layers,
        "fused_conv_encoder": w2v2_forwards * len(wcfg.conv_dims),
    }
    log(f"launch counts {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError("the main path did not launch the kernels as "
                             "expected")

    # The same requests on the plain path, same weights, same card.
    plain = InferenceEngine(dev)
    plain._video_extractor = VideoFeatureExtractor(
        vcfg, device=dev, use_kernels=False,
        params=engine.video_extractor.model.state_dict())
    plain._audio_embedder = AudioEmbedder(
        wcfg, device=dev, use_kernels=False,
        params=engine.audio_embedder.model.state_dict())
    plain._fusion = engine.fusion
    plain_probs = serve(plain, "plain")
    f32 = dataclasses.replace
    video32 = VideoFeatureExtractor(
        f32(vcfg, compute_dtype="float32"), device=dev, use_kernels=False,
        params=engine.video_extractor.model.state_dict())
    audio32 = AudioEmbedder(
        f32(wcfg, compute_dtype="float32"), device=dev, use_kernels=False,
        params=engine.audio_embedder.model.state_dict())
    for (name, entry, args), kp, pp in zip(requests, kernel_probs,
                                           plain_probs):
        wave = args[1] if entry == "predict_chunks" else args[2]
        v = [e.embed_chunks(args[0]) for e in
             (engine.video_extractor, plain.video_extractor, video32)]
        a = [e.embed_batch([wave]) for e in
             (engine.audio_embedder, plain.audio_embedder, audio32)]
        rv, rv_k32, rv_p32 = (_rel_l2(v[0], v[1]), _rel_l2(v[0], v[2]),
                              _rel_l2(v[1], v[2]))
        ra, ra_k32, ra_p32 = (_rel_l2(a[0], a[1]), _rel_l2(a[0], a[2]),
                              _rel_l2(a[1], a[2]))
        log(f"embeddings, {name}: audio kernel vs plain rel-L2 {ra:.3e} "
            f"(limit {EMBED_REL_L2}; vs f32 path: kernel {ra_k32:.3e}, plain "
            f"{ra_p32:.3e}); video kernel vs plain {rv:.3e}, vs f32 path: "
            f"kernel {rv_k32:.3e}, plain {rv_p32:.3e} (limit "
            f"{VIDEO_F32_FACTOR} x plain); probabilities max abs diff "
            f"{float(np.abs(kp - pp).max()):.3e}")
        if ra >= EMBED_REL_L2:
            raise AssertionError(f"{name}: audio embeddings moved beyond the "
                                 "feature-noise contract")
        if rv_k32 > VIDEO_F32_FACTOR * rv_p32:
            raise AssertionError(f"{name}: the kernels move video embeddings "
                                 "further from f32 than the plain bf16 path")
    return launches


if __name__ == "__main__":
    sys.exit(main())
