#!/usr/bin/env python3
"""Smoke run of the PyTorch port's clip, extraction, probe, int8, training and
data-prep paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. device: print the card's name and power limit (``nvidia-smi``); exit
   non-zero when CUDA is unavailable -- there is no CPU fallback.  Then a
   fixed host workload (``host_reference``: a Python loop, a numpy copy,
   the native cascade on the packaged face), logged, so that a slow phase
   can be put down to the host or to the code; each phase's wall time is
   logged at the end.
2. build: compile every kernel under ``mmer_tpu_torch/csrc`` with nvcc.
3. kernels: each of the eight kernels against its plain PyTorch version,
   both on the card, at the shapes the main paths give it (the serving
   requests' and both Wav2Vec2 forwards of the extraction folder,
   ``EXTRACT_WAVES``): max / mean absolute error
   against the tolerances in ``TOLERANCES``; its time, the plain version's
   and, where one PyTorch call computes the same function
   (``scaled_dot_product_attention``), that call's (CUDA events, after
   warm-up); and the least time the card could take, from the shapes
   (``bound_ms``).  The two conv routes (``mega`` on and off) are also held
   against each other, and the whole-pyramid route's seven launches are timed
   one by one, each beside its bound, its grid and a yardstick no port code
   calls (``F.conv1d`` in bf16, ``F.layer_norm``, ``F.gelu``: three library
   calls; the per-layer route's two kernels get the same, with their grids
   logged).  Every kernel case is called twice
   on the same inputs and must give the same bits; ``fused_ffn`` also runs at
   every grid plan a serving request reaches (``ffn_plan``: 65, 998 and 1,500
   tokens x 1024) and logs the plan beside each time.
   ``fused_ln_matmul`` runs at the profile shape and at
   the Wav2Vec2 width; every mode of ``attention_variant`` at the probe shape
   (16, 12, 1569, 64) padded to 1664 keys, the two ``p = scores`` modes on
   the rows whose plain denominator is at least ``DEN_MIN`` in magnitude.
3a. random stream: the threefry kernel (``csrc/threefry.cu``, the port's own:
   ``jax.random``'s draws, not a TPU kernel) against its plain version on the
   card, bit for bit and the same bits on a second call, at the draws the
   trainers make at ``ModelConfig()`` width: a training step at batch 64 (the
   11 dropout masks, modality dropout's ``u`` and the sort keys of mixup's
   ``j``), phase 9's global batch of 256, four seed lanes, and the epoch
   permutation of 6,796 rows; its device time (torch.profiler), the call's
   and the plain version's, beside the bound (integer operations or bytes).
   One launch a training step (``train/keys.py:KeySchedule.draw``).  The
   card's draws of both key schedules against JAX's own
   (``mmer_tpu_torch/assets/jax_draws.npz``, written by ``tests/test_torch_prng.py
   --write``): permutations, sampled mask elements, ``u``, ``j``, an epoch of
   mixup ``λ`` and 32-bit bits, all equal.  Then ``scripts/profile_train.py``
   at full width: ms a step, device busy, idle share, device operations and
   threefry launches a step (the profiled steps and the shuffle).
3b. JAX weights (after phase 3): the full default ViViT and Wav2Vec2
   param trees regenerated on the card from the JAX package's seeds
   (``models/jax_init.py``; each random leaf one threefry launch, counted),
   timed, every leaf held at the committed
   fixture's sampled indices (``mmer_tpu_torch/assets/jax_reference.npz``,
   written by ``tests/test_torch_jax_weights.py --write``) within
   ``JAX_MAX_ULP`` (the bit-equal share and the worst ulp logged); the
   default extractors' weights equal to those trees; the fixture's seeded
   inputs (two uint8 chunks, 3.2 / 12 / 0.5 s of audio) through
   ``VideoFeatureExtractor`` and ``AudioEmbedder`` on the f32 plain path
   (within ``JAX_F32_REL_L2`` of JAX's f32 features a row), the default
   kernel route and the all-kernel audio route (audio within
   ``EMBED_REL_L2`` a clip of JAX's bf16 features on its Pallas route, which
   the kernels mirror; its XLA route's are logged; video, over both chunks,
   within ``JAX_VIDEO_BF16_FACTOR`` times JAX's own bf16-to-f32 distance of
   JAX's f32 features), with exact launch counts; the phase within
   ``JAX_PHASE_LIMIT_S``.
3c. positional conv: the port's own kernel for Wav2Vec2's positional-conv
   sublayer (``csrc/pos_conv.cu``; not a TPU kernel: XLA compiles the JAX
   package's grouped conv, ``mmer_tpu/models/wav2vec2.py:185``) against its
   plain version at both extraction forwards' shapes (64 x 249 / 499
   frames) and the serving shapes (1 x 65 / 149 / 1,500, 2 x 499), masks
   with a fully padded row, within ``TOLERANCES["pos_conv"]`` and the same
   bits twice; its time (CUDA events and the launch's device time from
   torch.profiler), the plain version's and cuDNN's ``F.conv1d`` + bias +
   GELU + residual on pre-cast operands (timed only), beside the bound and
   the grid plan.  Every later phase counts its launches with the other
   kernels': one a Wav2Vec2 forward on the kernel route.
3d. plain attention: the port's own kernel for Wav2Vec2's plain attention
   (``csrc/plain_attention.cu``; not a TPU kernel: XLA compiles the JAX
   package's ``_xla_attention``, ``mmer_tpu/models/wav2vec2.py:304``)
   against its plain version, the torch route, at the positional conv's
   shapes, masks with a fully padded row, within
   ``TOLERANCES["plain_attention"]``, the same bits twice and on the fused
   projection's column slices; its time (CUDA events and the launch's
   device time), the plain version's and ``scaled_dot_product_attention``'s
   (timed only), beside the bound.  Every later phase counts its launches:
   one a layer of a Wav2Vec2 forward on the kernel route without flash
   attention.
4. main path: ``InferenceEngine`` at the full default configs with the JAX
   package's seeded weights serves three requests (``predict_chunks`` on a
   3-chunk clip with 3.2 s of audio and on a 1-chunk clip with 12 s of
   audio, ``infer_sequence`` on 5 subchunks at 30 fps).  Probabilities must
   be finite and sum to 1, and every kernel's launch count must rise by
   exactly what the requests imply.  The same requests then run on the
   plain path on the card, and their embeddings are also computed on an
   f32 plain path: audio embeddings of the kernel and plain paths must
   agree within 0.5 % relative L2 (the extractor feature-noise contract);
   video embeddings of the kernel path must be no further from the f32
   path than the plain bf16 path's (see ``VIDEO_F32_FACTOR``).
4b. serving file path: ``InferenceEngine.infer_frames`` at the same full
   configs with the native Haar cascade (its numpy fallback fails the run)
   on 480x640 frames holding the packaged face
   (``mmer_tpu_torch/assets/face_300x256.npy``, seeded jitter): A, 96 face
   frames with 3.2 s of audio; B, 160 frames with the face gone from frames
   64-79 (two sequences), with IG explanations, and again without; C, 32
   frames with no face.  The audio comes through the port's container code:
   a synthetic H.264 + AAC FLV through the HTTP server's ``/remux/``, a
   seeded PCM track muxed in, ``extract_audio_track`` on the written file.
   Gates: boxes on at least 90 % of the face frames and none elsewhere, the
   best box's IoU with the face at least 0.5, items at the first frame of
   each subchunk, probabilities finite and normalised, exact launch counts
   per request (C launches nothing), the same classes with and without IG,
   finite attributions whose completeness residual matches an f32 CPU run
   within ``IG_RESIDUAL_TOL``; ``/ping``, ``/health``, ``/remux/`` (the bytes
   of ``flv_to_mp4``), 422 and 413 from the server.  Each request's warm
   latency is logged by stage.
4c. cold start, in fresh processes (the kernels already built):
   ``scripts.bench_serving --route frames`` with ``--no_warmup`` (the cold
   first request), then with a warmup (``--warmup_resolutions 256x300``
   and a decoded sample, ``--warmup_upload``), ``COLD_REQUESTS`` requests
   a leg, then ``scripts.bench_extract``.  Gates: every process exits 0;
   the warmed first request (``explain=true``) within
   ``COLD_FIRST_FACTOR`` times the warm ``explain_p50_ms``; no kernel
   library built after the warmup; the warmup launched ``flash_attention``,
   ``fused_ffn`` and ``fused_conv_encoder``; the phase within
   ``COLD_START_LIMIT_S``.  Logged: both first requests, the warmup's
   phases, p50 / p95, the novel-resolution requests and bench_extract's
   four numbers.
5. extraction: 96 seeded WAV files (1.5-5 s, one 12 s, one 44.1 kHz stereo,
   one 10 ms) → ``mmer_tpu_torch.preprocess.extract.main`` → 96 float16
   (1024,) artifacts; the same folder through ``iter_audio_embeddings`` on
   the default embedder, the all-kernel encoder (varlen flash attention and
   the per-layer conv route) and the plain path, with exact launch counts
   per Wav2Vec2 forward, clips/s of each, and each kernel route within
   0.5 % relative L2 of the plain path per clip; 24 seeded chunks through
   ``embed_chunks`` with and without ``pipeline``: identical rows, four
   timed calls of each.

6. profile: ``mmer_tpu_torch.scripts.profile_fused_blocks.main`` and
   ``mmer_tpu_torch.scripts.probe_attn.main`` at their full shapes, with the
   launch counts of ``fused_ln_matmul``, ``fused_ffn`` and every attention mode
   held to what the scripts' inputs and passes imply; then the component
   profiles ``scripts.profile_vivit`` (ViViT-B at B = 16: the model on the
   kernel and the plain route, attention alone on both, the model without
   attention) and ``scripts.profile_w2v2`` (Wav2Vec2-large at 64 x 3.2 s in
   the 4 s bucket: the default route, the conv encoder alone, the
   transformer alone), every leg's ms, TFLOP/s, device busy ms and idle
   share logged, kernel rows 1-3 launched exactly as the legs' calls imply.
6b. component probes: the conv-encoder profiles and the extractor A/B
   probes through their ``main`` at full width, three distinct inputs a
   leg: ``scripts.profile_conv_pyramid`` (the conv encoder at 64 x
   64,000 samples on the plain, per-layer and whole-pyramid routes, each
   beside its bound, and the whole embedder plain and on kernels),
   ``scripts.profile_cp_layers`` (each per-layer conv kernel alone on inputs
   drawn on the card), ``scripts.probe_w2v2_flash`` and
   ``scripts.probe_w2v2_qkv`` (the encoder with plain against flash
   attention, separate against fused q/k/v, a quarter of the clips padded),
   ``scripts.probe_vivit_b32`` (the ViViT at B = 16 and 32) and
   ``scripts.probe_extract_pipeline`` (96 uint8 chunks through
   ``embed_chunks``, serial and pipelined, best of two calls each).
   Gates: every row a device time (CUDA events), but for the pipeline
   probe's, which are wall-clock times of whole ``embed_chunks`` calls on
   the card (host staging overlapped with the card is what that probe
   measures), rows 1-6 launched exactly as each
   script's calls imply, both kernel conv routes within the conv bound of the
   plain route, each A/B's two variants within ``EMBED_REL_L2`` a clip, the
   pipelined rows bit-identical to the serial ones.
6c. int8 path (``ops/quant.py``, ``csrc/qdot.cu``: the port's own kernel,
   not a TPU one; XLA compiles JAX's int8 ``dot_general`` and the quantize
   around it): ``row_quant``, ``qdot_int8`` and ``qdot_u8`` against their
   plain versions at every GEMM shape of the two int8 forwards
   (``probe_int8.MODEL_GEMMS``: ViViT-B at B = 16, Wav2Vec2-large at 64 x 4
   s, each with the input dtype the model feeds it, the tubelet projection
   on uint8 pixels, 3,072 deep), bit for bit and the same bits on a second call; each GEMM's
   and ``row_quant``'s device time (torch.profiler), the call's, the plain
   version's, ``torch._int_mm`` with the dequantize in PyTorch (the
   library's), bf16 ``torch.matmul`` at the shape, and the bound at the int8
   peak.  Then ``scripts.probe_int8``, ``probe_int8_vivit`` and
   ``probe_int8_w2v2`` through their ``main`` at full width, three distinct
   inputs a leg: exact launches (a ViViT forward 1 ``qdot_u8``, 48
   ``qdot_int8``, 48 ``row_quant``, 12 attention; a Wav2Vec2 forward 97
   ``qdot_int8``, 97 ``row_quant``, 7 conv; no FFN kernel), cosine at least
   ``INT8_COS_MIN`` to the bf16 route every chunk and clip, the kernel routes
   within ``INT8_ROUTE_REL_L2`` of the plain routes and the plain-attention
   ViViT leg bit-identical to its plain route; every leg's ms, rate and
   speedup logged.  No other phase launches an int8 kernel.
7. training: 8,496 seeded samples written as ``.npy`` feature artifacts
   under CREMA-D / RAVDESS names → ``mmer_tpu_torch.train.cli.main`` at
   ``ModelConfig()`` width for ``TRAIN_EPOCHS`` epochs at batch 64 on JAX's
   epoch-loop key schedule (exactly one threefry launch a random leaf of the
   initial weights, a shuffle and a step): the train loss must be finite and
   fall, the validation accuracy beat chance, the
   confusion matrix sum to the test split, the artifacts exist; then
   ``InferenceEngine`` loads the trained head and its normalisation
   statistics and answers one request.
8. flagship chain: 8,496 seeded samples as in 7, at ``FLAGSHIP_CLASS_SIGNAL``
   → ``mmer_tpu_torch.scripts.make_flagship.main`` at ``ModelConfig()``
   width with ``--pool_seeds 2 --student_seeds 2 --epochs FLAGSHIP_EPOCHS``:
   four seed-batched pool calls of S = 2 (``train/fused.train_many_seeds``),
   the top-half teacher, one student call.  Gates: every member's train
   loss finite and falling, the two seeds of a call different, pool seed 0
   of the winning recipe rerun alone through ``train_model(fused=True)`` (the
   same key schedule: lane 0 and the solo run share every draw) within
   ``FLAGSHIP_LOSS_RTOL`` of its batched rows with the same best epoch,
   teacher rows summing to 1, the student's
   validation accuracy above twice chance, ``flagship.msgpack``,
   ``norm_stats.npz`` and ``manifest.json`` with the JAX manifest's keys,
   ``resolve_default_fusion`` finding the ``.msgpack``, the engine's weights
   bit for bit the student's, and one request with finite probabilities
   summing to 1 whose kernel launches equal the training phase's request.
   Logged: seconds an epoch and samples/s per seed, solo (the rerun),
   S = 2 (a warm pool call) and S = 4 (a 2-epoch call of four seeds), peak
   device memory, the phase's wall time.
8b. quality scripts (before the training phase's folders are removed):
   ``scripts.{sweep,quality_sweep,probe_recipe_sweep_r4,probe_ensemble,
   probe_diverse_ensemble,probe_mixup_quality,probe_feature_noise_quality,
   probe_distill}`` through their ``main`` at ``ModelConfig()`` width on
   phase 7's 8,496 pairs, 1 epoch, the fewest seeds each takes (2 where it
   batches seeds; ``QUALITY_ARGS``): every number of each summary finite,
   every F1 in [0, 1], no extractor kernel launched; each script's wall time
   and the phase's threefry launches logged.

9. scale-out: a one-rank NCCL world on ``cuda:0`` (the card is one; no
   multi-rank run takes place on it): ``VideoFeatureExtractor(mesh=)`` on
   phase 5's 24 chunks (serial and pipelined) and ``AudioEmbedder(mesh=)``
   on its 96 waves on both routes, bit-equal to the single-device paths with
   the same launches; ``train_model(mesh_cfg=MeshConfig())`` for
   ``SCALE_OUT_EPOCHS`` epochs on phase 7's 8,496 pairs (written anew from
   its seed), rows and final weights bit-equal to the single-device run's,
   the run log's ``"mesh"`` ``{"data": 1, "model": 1}``, and the same mesh
   run cut after epoch 1 and resumed from its mid-run checkpoint, bit-equal
   to the uninterrupted one; the native load of the pairs against numpy's
   on every ``NUMPY_LOAD_STRIDE``-th pair (equal arrays, both timed);
   ``train_streaming`` over the same folders, every batch through the
   native loader, seconds an epoch beside the in-memory trainer's; the scaling probe's JSON lines at
   n = 1 and ``core.check``'s matmul rate; the phase within
   ``SCALE_OUT_LIMIT_S``.

10. prep chain (``scripts/full_chain.py:run_chain`` on raw frames in memory:
   the card has no container codec): 60 raw 360x480 clips (10 actors x 6
   emotions, 40-72 frames, the packaged face translating over a textured
   background, four clips in six tilted by +-30 degrees or 40 % covered on
   frames 8-23) and six held-out ones → ``extract_frame_bboxes`` with the
   native cascade (ms a frame; rows by source, relaxed and tracked > 0; the
   ``.txt`` round trip) → face crops on the card, every batch within 1 grey
   level of the CPU's → the default ViViT-B and Wav2Vec2-large (label tones
   written as WAVs) → ``dataset_from_feature_maps`` equal to
   ``load_dataset`` of the written ``.npy`` → ``train.cli`` at full_chain's
   recipe (batch 16, lr 1e-4, 60 epochs): best test accuracy above 80 % →
   each held-out clip through ``InferenceEngine.infer_frames`` (detection
   every third frame) and the span-weighted vote: at least 5 of 6
   recovered; rows 1-3 launched.  Every ViViT and Wav2Vec2 call of the
   chain, extraction and serving, is then re-run on the plain route and
   the f32 path: per group, the kernel route no further from f32 than the
   plain route, within ``VIDEO_F32_FACTOR``; one 32-frame 720x1280
   clip is tracked, timed; the phase's wall time.

The second-to-last line is ``{"kernels": [...]}`` (``launches_scale_out``:
the mesh runs' launches; ``launches_prep_chain``: phase 10's;
``launches_cold_start_warmup``: phase 4c's warmup's, in its own process;
``launches_component_probes``: phase 6b's; ``threefry``'s launches are the
training phase's, its ``launches_training`` also phase 8b's; the int8
kernels' are phase 6c's, with one key a case: ``ms_<case>``, ...), after a
line ``{"int8_probes": ...}`` with the three probes' legs; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
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
    # f32 stream: only bf16 roundings of the hidden units can flip.  One
    # flip of a hidden unit in [4, 8) is a step of 2^-5, times a weight of
    # 4.5 sigma (0.07): 2.2e-3; two sets of seeded data read 1.8e-3 and 2.5e-3.
    "fused_ffn_w2v2": (4e-3, 1e-4),
    # The same stream at the extraction shape, 16.3 M outputs against 0.15 M:
    # the mean bound is the same, the largest of 107 times as many flips is
    # further out (3.6e-3 read where the small shape reads 1.8e-3).
    "fused_ffn_w2v2_extract": (8e-3, 1e-4),
    # seven bf16 layers; a flipped rounding propagates through LayerNorm
    # into the next layer.  The repository's own bound for this comparison
    # (tests/test_conv_pyramid.py, Pallas kernel vs XLA module in bf16).
    "fused_conv_encoder": (0.06, 5e-3),
    # The 10 s extraction batch, 16.3 M outputs, twice the 5 s batch's: the
    # mean bound is the same, the largest of twice as many flips read 0.0625
    # (two steps of 2^-5) where the smaller shapes read 0.0469.
    "fused_conv_encoder_10s": (0.08, 5e-3),
    # The prep chain's batch, 64 clips of 3 s (4.9 M outputs): on an H100
    # both conv routes read 0.0625 from the plain version (two steps of
    # 2^-5) while agreeing with each other bit for bit, so the flips are the
    # plain version's own bf16 roundings; the f32-path check below holds the
    # routes' accuracy.  Extraction-size batches take the 10 s batch's bound.
    "fused_conv_encoder_prep": (0.08, 5e-3),
    # one conv layer on unit-normal rows: a flipped bf16 rounding of the conv
    # sum moves an O(1) output by a few bf16 steps (tests/test_torch_cuda.py).
    "conv_layer": (0.0625, 1e-3),
    # The positional-conv sublayer on a unit-normal stream: the same rounding
    # points as the plain version, so only the order of an output's 8,192
    # f32 products differs, which flips the bf16 rounding of a conv output
    # now and then: a step or two of the rounded GELU, 2^-5 at values in
    # [4, 8) (tests/test_torch_pos_conv.py).  An H100 read 0.0469 / 8.6e-7.
    "pos_conv": (2 ** -4, 2 ** -14),
    # Plain attention, as fractions of max and mean |plain| (the plain
    # version's f32 output): the kernel rounds its output once to bf16 (half
    # a step, 2^-8 of a value at most, about 2^-10 on average), and where its
    # f32 exp and sum differ from the plain version's by an ulp a P rounds to
    # the neighbouring bf16 value now and then.  The kernel's order on the
    # CPU (tests/test_torch_plain_attention.py) reads 2^-8.5 / 2^-9.5, an
    # H100 2^-8.9 / 2^-9.7.
    "plain_attention": (2 ** -7, 2 ** -8),
}
TOLERANCES["flash_attention_varlen"] = TOLERANCES["flash_attention"]
# Same rounding points as the plain version (LN rounded to bf16, one rounding
# of the f32 product): only summation order can flip the last rounding, for a
# handful of the 58 M outputs.  One bf16 ulp of an output v is at most
# 2^-7 |v|, hence the bound on the max, as a fraction of max |plain|; the
# mean, as a fraction of mean |plain|, reads 2-3e-6.
TOLERANCES["fused_ln_matmul"] = (2 ** -7, 2 ** -15)
# Every mode whose p is a softmax or a shifted score: the attention bound.
TOLERANCES["attention_variant"] = TOLERANCES["flash_attention"]
RELATIVE = {"flash_attention", "flash_attention_varlen", "attention_variant",
            "fused_ln_matmul", "plain_attention"}
# The two ``p = scores`` modes divide by a sum of signed scores, which comes
# near zero on a few per cent of rows.  They are compared on the rows whose
# plain |denominator| is at least DEN_MIN, as implied numerators
# (|kernel - plain| * |denominator|): at most 2^-6 of max |numerator| (a
# flipped bf16 rounding of the output is 2^-8 to 2^-7 of it) and 2^-9 of mean
# |numerator| on average.
DEN_MIN = 4.0
PRODUCTS_ONLY_TOL = (2 ** -6, 2 ** -9)
PROBE_SHAPE = (16, 12, 1569, 64)
PROBE_S_PAD = 1664
TRAIN_EPOCHS = 4
CLASS_COUNTS = (1183, 1463, 1462, 1463, 1463, 1462)   # NEU HAP SAD ANG FEA DIS
# Each class's mean direction is added to unit-normal features at this
# strength: ~1.4 sigma per video row and per audio vector, so that the
# classes overlap and the loss keeps falling over the epochs.
CLASS_SIGNAL = 0.05
FLAGSHIP_EPOCHS = 4
# The flagship recipe trains at lr 1e-5, a tenth of the training phase's: on
# CLASS_SIGNAL's data four epochs of it stay below the phase's twice-chance
# gate, on twice that signal they pass it by far.
FLAGSHIP_CLASS_SIGNAL = 0.1
# Pool seed 0 batched (S = 2: each layer's GEMM a stacked one) against the
# same seed alone, per-epoch train and validation losses.  The fusion GEMMs
# round to bf16 and the two GEMMs sum in different orders: on an H100 the two
# runs read 7.6e-4 to 1.0e-3 apart (in float32 the CPU tests hold them within
# 1e-5).  The limit is a bf16 step, 2^-8 = 3.9e-3, with a margin.
FLAGSHIP_LOSS_RTOL = 5e-3
# The waveform batches of the extraction phase's two Wav2Vec2 forwards: 64
# clips of up to 5 s, then 33 pieces (batch bucket 64) with a 10 s piece.
# The kernel phase holds every Wav2Vec2 kernel at both; the extraction phase
# fails if its forwards see other shapes.
EXTRACT_WAVES = ((64, 80000), (64, 160000))
# The prep chain's one extraction forward: its 60 clips of at most 2.4 s in
# one 3 s bucket of 64 rows.  The kernel phase holds the Wav2Vec2 kernels
# at it too; the prep chain fails if its extraction runs at another shape.
PREP_WAVES = (64, 48000)
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
# Phase 3b, the JAX package's weights: the regenerated leaves may sit this
# many float32 ulp from the fixture's (jax's own draws on the CPU); the f32
# plain path this far (rel-L2 a row) from JAX's f32 features; the bf16 kernel
# route's video this many times as far from JAX's f32 features as JAX's own
# bf16 features are (C1: any two bf16 ViViTs sit ~0.8 % apart); audio within
# EMBED_REL_L2 of JAX's bf16 features.  Both full trees regenerate within
# REGEN_LIMIT_S and the phase within JAX_PHASE_LIMIT_S.
JAX_MAX_ULP = 4
JAX_F32_REL_L2 = 1e-4
JAX_VIDEO_BF16_FACTOR = 1.25
REGEN_LIMIT_S = 20.0
JAX_PHASE_LIMIT_S = 60.0
# The serving file path's frames: the packaged face pasted at (y, x) on a
# 480x640 background; the face itself (ear to ear, brow to chin) lies at
# (x1, y1, x2, y2) in the 300x256 asset, read off the image.
FACE_AT = (90, 192)
FACE_RECT = (80, 50, 180, 160)
# IG completeness does not hold for the fusion model at a zero baseline (a
# LayerNorm after each bias-free input projection makes f(ax) a step near
# a = 0 that 50 Gauss-Legendre nodes cannot resolve: f32 residuals of a third
# of a logit on the served windows).  The card's residual must instead match
# an f32 CPU run's on the same inputs and targets: on an H100 they read at
# most 0.0569 logits apart over the five windows; the limit is 3.5 times that.
IG_RESIDUAL_TOL = 0.2
SOURCES = {
    "flash_attention": ("mmer_tpu_torch/csrc/attention.cu",
                        "mmer_tpu/ops/flash_attention.py:51"),
    "fused_ffn": ("mmer_tpu_torch/csrc/ffn.cu",
                  "mmer_tpu/ops/fused_blocks.py:135"),
    "fused_conv_encoder": ("mmer_tpu_torch/csrc/conv_encoder.cu",
                           "mmer_tpu/ops/conv_pyramid.py:278"),
    "flash_attention_varlen": ("mmer_tpu_torch/csrc/attention.cu",
                               "mmer_tpu/ops/flash_attention.py:95"),
    "conv_gemm_ln_gelu": ("mmer_tpu_torch/csrc/conv_layers.cu",
                          "mmer_tpu/ops/conv_pyramid.py:91"),
    "conv_k3_ln_gelu": ("mmer_tpu_torch/csrc/conv_layers.cu",
                        "mmer_tpu/ops/conv_pyramid.py:97"),
    "fused_ln_matmul": ("mmer_tpu_torch/csrc/ln_matmul.cu",
                        "mmer_tpu/ops/fused_blocks.py:88"),
    "pos_conv": ("mmer_tpu_torch/csrc/pos_conv.cu",
                 "mmer_tpu/models/wav2vec2.py:185 (XLA's grouped nn.Conv; "
                 "not a Pallas kernel)"),
    "plain_attention": ("mmer_tpu_torch/csrc/plain_attention.cu",
                        "mmer_tpu/models/wav2vec2.py:304 (XLA's _xla_attention; "
                        "not a Pallas kernel)"),
}
# The probe kernels of scripts/probe_attn.py, by the kernel body each mode ran.
SOURCES.update({
    f"attention_variant[{mode}]": ("mmer_tpu_torch/csrc/attention.cu",
                                   f"scripts/probe_attn.py:{line}")
    for mode, line in (("full", 39), ("nomask", 39), ("noexp", 39),
                       ("nosoftmax", 39), ("mxumask", 115), ("kt", 77),
                       ("kt_nosoftmax", 77))})
# Kernels that only the profile and probe scripts launch.
PROBE_KERNELS = tuple(k for k in SOURCES
                      if k == "fused_ln_matmul" or k.startswith("attention_variant"))


def wrappers() -> dict:
    """Kernel name → the wrapper that counts its launches."""
    from mmer_tpu_torch.ops import conv_pyramid
    from mmer_tpu_torch.ops.flash_attention import (flash_attention,
                                                    flash_attention_varlen)
    from mmer_tpu_torch.ops.fused_blocks import fused_ffn, fused_ln_matmul
    from mmer_tpu_torch.ops.plain_attention import plain_attention
    from mmer_tpu_torch.ops.pos_conv import pos_conv_residual
    from mmer_tpu_torch.ops.quant import qdot_int8, qdot_u8, row_quant

    return {"flash_attention": flash_attention, "fused_ffn": fused_ffn,
            "fused_ln_matmul": fused_ln_matmul,
            "fused_conv_encoder": conv_pyramid.fused_conv_encoder,
            "flash_attention_varlen": flash_attention_varlen,
            "conv_gemm_ln_gelu": conv_pyramid._call_gemm,
            "conv_k3_ln_gelu": conv_pyramid._call_k3,
            "pos_conv": pos_conv_residual, "plain_attention": plain_attention,
            "row_quant": row_quant, "qdot_int8": qdot_int8, "qdot_u8": qdot_u8}


def reset_launches() -> None:
    from mmer_tpu_torch.ops.attention_variants import attention_variant
    from mmer_tpu_torch.ops.fused_blocks import fused_ffn

    for w in wrappers().values():
        w.launches = 0
    for mode in attention_variant.launches:
        attention_variant.launches[mode] = 0
    fused_ffn.reduce_launches = 0      # the FFN's second pass, counted apart


def read_launches() -> dict:
    """Launch count of every kernel, the attention probe's per mode."""
    from mmer_tpu_torch.ops.attention_variants import attention_variant

    out = {k: w.launches for k, w in wrappers().items()}
    out.update({f"attention_variant[{mode}]": n
                for mode, n in attention_variant.launches.items()})
    return out


def bound(flops: float, nbytes: float, tag: str = "") -> dict:
    """``timing.bound_ms`` (each input read once, each output written once),
    logged, with keys that carry the case's ``tag``."""
    from mmer_tpu_torch.scripts.timing import PEAK_BYTES, PEAK_FLOPS, bound_ms

    log(f"  work: {flops / 1e9:.3f} GFLOP ({flops / PEAK_FLOPS * 1e3:.4f} ms "
        f"at the bf16 peak), {nbytes / 1e6:.3f} MB "
        f"({nbytes / PEAK_BYTES * 1e3:.4f} ms at the memory rate)")
    ms, by = bound_ms(flops, nbytes)
    return {f"bound_ms{tag}": ms, f"bound_by{tag}": by}


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
    from mmer_tpu_torch.scripts.timing import event_ms

    return event_ms(fn, iters, warmup)


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


def _same_bits(name: str, first, second) -> None:
    """The kernels sum in a fixed order: a second call gives the same bits."""
    import torch

    same = bool(torch.equal(first, second))
    log(f"kernel {name}: a second call on the same inputs gives "
        f"{'the same bits' if same else 'OTHER BITS'}")
    if not same:
        raise AssertionError(f"{name}: two calls on the same inputs differ")


def _conv_layer_args(cfg, randn):
    """Seeded conv-stack parameters: weights (C_out, C_in, k), conv biases,
    LayerNorm weights and biases, one list each."""
    c_in, layer = 1, []
    for dim, kk in zip(cfg.conv_dims, cfg.conv_kernels):
        layer.append((randn(dim, c_in, kk, std=(kk * c_in) ** -0.5),
                      randn(dim, std=0.1), 1.0 + randn(dim, std=0.1),
                      randn(dim, std=0.1)))
        c_in = dim
    return [list(t) for t in zip(*layer)]


def _layer_lengths(cfg, n: int) -> list:
    """Output length of each conv layer for ``n`` samples."""
    out = []
    for k, s in zip(cfg.conv_kernels, cfg.conv_strides):
        n = (n - k) // s + 1
        out.append(n)
    return out


def _conv_bound(cfg, wave, conv_args, out, tag) -> dict:
    flops, c_in = 0.0, 1
    for dim, k, t in zip(cfg.conv_dims, cfg.conv_kernels,
                         _layer_lengths(cfg, wave.shape[1])):
        flops += 2.0 * wave.shape[0] * t * k * c_in * dim
        c_in = dim
    from mmer_tpu_torch.scripts.timing import tensor_bytes

    return bound(flops, tensor_bytes(wave, out, *(t for ts in conv_args for t in ts)),
                 tag)


def conv_layer_ms(wave, conv_args, cfg, iters: int) -> list:
    """Device time of each of ``fused_conv_encoder``'s seven launches, read
    from a torch.profiler trace of ``iters`` calls after a warm-up one, so
    that the host's time between two launches is not counted."""
    from mmer_tpu_torch.ops.conv_pyramid import fused_conv_encoder
    from mmer_tpu_torch.scripts.timing import kernel_device_ms

    return kernel_device_ms(lambda: fused_conv_encoder(wave, *conv_args, cfg),
                            "ln_gelu_kernel", iters, len(cfg.conv_dims))


def three_call_ms(x_cf, weight, conv_bias, ln_w, ln_b, stride: int, iters: int) -> float:
    """The yardstick of one conv layer: ``F.conv1d`` over the channels-first
    bf16 input, ``F.layer_norm`` over the channels, ``F.gelu``, in bf16.
    Timed only: the port never calls it, and no single call computes the
    layer (hence no ``library_ms``)."""
    import torch
    import torch.nn.functional as F

    from mmer_tpu_torch.ops.fused_blocks import LN_EPS

    bf = torch.bfloat16
    w, cb, lw, lb = (t.to(bf) for t in (weight, conv_bias, ln_w, ln_b))
    x = x_cf.to(bf).contiguous()

    def layer():
        y = F.conv1d(x, w, cb, stride=stride).transpose(1, 2)
        return F.gelu(F.layer_norm(y, (w.shape[0],), lw, lb, LN_EPS))

    return cuda_ms(layer, iters)


def four_call_ms(x, ln_w, ln_b, w1, b1, w2, b2, iters: int) -> float:
    """The yardstick of the FFN sublayer: ``F.layer_norm`` in x's dtype,
    ``F.linear``, ``F.gelu``, ``F.linear`` plus the residual, the products
    in the weights' bf16 (an f32 stream's LN output cast to it, the
    residual added in f32), as the kernel computes them.  Timed only: the
    port never calls it, and no single call computes the sublayer (hence no
    ``library_ms``)."""
    import torch.nn.functional as F

    from mmer_tpu_torch.ops.fused_blocks import LN_EPS

    lw, lb = ln_w.to(x.dtype), ln_b.to(x.dtype)
    b1c, b2c = b1.to(w1.dtype), b2.to(w2.dtype)
    d = x.shape[-1]

    def sublayer():
        y = F.layer_norm(x, (d,), lw, lb, LN_EPS).to(w1.dtype)
        return x + F.linear(F.gelu(F.linear(y, w1, b1c)), w2, b2c)

    return cuda_ms(sublayer, iters)


def conv_layers_report(dev, cfg, wave, conv_args, iters: int, tag: str) -> dict:
    """Per-layer device times of the whole-pyramid route with each layer's
    bound, three-call yardstick on inputs of the layer's shape, and the grid
    its launch used (logged)."""
    import torch

    from mmer_tpu_torch.ops.conv_pyramid import fused_conv_encoder
    from mmer_tpu_torch.scripts.timing import PEAK_BYTES, PEAK_FLOPS

    bsz = wave.shape[0]
    lengths = _layer_lengths(cfg, wave.shape[1])
    ms = conv_layer_ms(wave, conv_args, cfg, iters)
    grids = fused_conv_encoder.last_grids
    out = {f"layer_ms{tag}": ms, f"layer_three_call_ms{tag}": [],
           f"layer_bound_ms{tag}": []}
    t_in, c_in = wave.shape[1], 1
    for i, (w, cb, lw, lb) in enumerate(zip(*conv_args)):
        k, s, t_out = cfg.conv_kernels[i], cfg.conv_strides[i], lengths[i]
        x_cf = (wave.unsqueeze(1) if i == 0 else
                torch.randn(bsz, c_in, t_in, device=dev, dtype=torch.bfloat16))
        yard = three_call_ms(x_cf, w, cb, lw, lb, s, iters)
        flops = 2.0 * bsz * t_out * k * c_in * 512
        moved = (x_cf.numel() * (4 if i == 0 else 2) + 512 * k * c_in * 2
                 + bsz * t_out * 512 * 2 + 3 * 512 * 4)
        t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, moved / PEAK_BYTES * 1e3
        grid = grids[i]
        out[f"layer_three_call_ms{tag}"].append(yard)
        out[f"layer_bound_ms{tag}"].append(max(t_ops, t_bytes))
        log(f"time conv layer {i} on {tuple(wave.shape)}: kernel {ms[i]:.4f} ms (device), "
            f"three library calls {yard:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms by "
            f"{'operations' if t_ops >= t_bytes else 'bytes'}, grid {grid} = "
            f"{grid[0] * grid[1]} blocks ({t_in} x {c_in} -> {t_out} x 512, k {k}, stride {s})")
        t_in, c_in = t_out, 512
        del x_cf
    return out


def check_kernels(dev) -> dict:
    """Each kernel vs its plain version at the main paths' shapes."""
    import torch
    import torch.nn.functional as F

    from mmer_tpu_torch.config import Wav2Vec2Config
    from mmer_tpu_torch.models.wav2vec2 import feat_extract_output_length
    from mmer_tpu_torch.ops.conv_pyramid import (_call_gemm, _call_k3,
                                                 conv_encoder_reference,
                                                 fused_conv_encoder,
                                                 gemm_ln_gelu_reference,
                                                 k3_ln_gelu_reference)
    from mmer_tpu_torch.ops.flash_attention import (flash_attention,
                                                    reference_attention,
                                                    reference_attention_varlen)
    from mmer_tpu_torch.ops.fused_blocks import ffn_reference, fused_ffn
    from mmer_tpu_torch.scripts.timing import kernel_device_ms, tensor_bytes

    g = torch.Generator(device=dev)
    case = iter(range(10 ** 6))

    def reseed():
        """Each case draws from a seed of its own, so that a case added or
        removed leaves the others' data as they were."""
        g.manual_seed(next(case))

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    bf = torch.bfloat16
    res = {}

    # ViViT attention: (8 chunks, 12 heads, 1569 tokens, 64).
    reseed()
    q, k, v = (randn(8, 12, 1569, 64, dtype=bf) for _ in range(3))
    got = flash_attention(q, k, v)
    want = reference_attention(q, k, v)
    torch.cuda.synchronize()
    r = _compare("flash_attention", got, want)
    _same_bits("flash_attention", got, flash_attention(q, k, v))
    r["ms"] = cuda_ms(lambda: flash_attention(q, k, v), 20)
    r["plain_ms"] = cuda_ms(lambda: reference_attention(q, k, v), 5)
    r["library_ms"] = cuda_ms(
        lambda: F.scaled_dot_product_attention(q, k, v), 20)
    r["shape"] = "q,k,v (8,12,1569,64) bf16"
    log(f"kernel flash_attention, {r['shape']}")
    r.update(bound(4.0 * 8 * 12 * 1569 * 1569 * 64, 4 * tensor_bytes(q)))
    res["flash_attention"] = r
    q, k = 3 * q, 3 * k
    r2 = _compare("flash_attention", flash_attention(q, k, v),
                  reference_attention(q, k, v))
    r.update(max_abs_err_sharp=r2["max_abs_err"],
             mean_abs_err_sharp=r2["mean_abs_err"])
    del q, k, v, got, want
    torch.cuda.synchronize()

    # Wav2Vec2 attention at the extraction forwards' shapes (64 rows, 16
    # heads, one key length per clip; lengths from a seed plus a full, a
    # one-tile and an empty clip), and at 4 s clips (199 frames).
    cfg = Wav2Vec2Config()
    t5, t10 = (feat_extract_output_length(cfg, n) for _, n in EXTRACT_WAVES)
    r = {}
    for tag, s in (("", t5), ("_10s", t10), ("_4s", 199)):
        reseed()
        q, k, v = (randn(64, 16, s, 64, dtype=bf) for _ in range(3))
        lens = torch.randint(int(0.3 * s), s + 1, (64,), generator=g, device=dev)
        lens[0], lens[1], lens[2] = s, 64, 0
        shape = f"q,k,v (64,16,{s},64) bf16, lens {int(lens.min())}..{s}"
        log(f"kernel flash_attention_varlen, {shape}")
        got = flash_attention(q, k, v, key_lens=lens)
        want = reference_attention_varlen(q, k, v, lens)
        torch.cuda.synchronize()
        valid = lens > 0
        r2 = _compare("flash_attention_varlen", got[valid], want[valid])
        _same_bits("flash_attention_varlen", got,
                   flash_attention(q, k, v, key_lens=lens))
        finite = bool(torch.isfinite(got.float()).all())
        uniform = v[2].float().mean(-2, keepdim=True).expand_as(got[2])
        zero_err = float((got[2].float() - uniform).abs().max())
        log(f"kernel flash_attention_varlen: the zero-length clip is "
            f"{'finite' if finite else 'NOT finite'}, max |row - mean of its "
            f"{s} values| {zero_err:.3e} (tol {2 ** -7:.3e})")
        if not finite or zero_err > 2 ** -7:
            raise AssertionError("flash_attention_varlen: a zero-length clip "
                                 "must come out finite and uniform")
        mask = ((torch.arange(s, device=dev) >= lens[:, None]).to(bf)
                * -1e9)[:, None, None, :]
        r.update({
            f"max_abs_err{tag}": r2["max_abs_err"],
            f"mean_abs_err{tag}": r2["mean_abs_err"],
            f"ms{tag}": cuda_ms(
                lambda: flash_attention(q, k, v, key_lens=lens), 20),
            f"plain_ms{tag}": cuda_ms(
                lambda: reference_attention_varlen(q, k, v, lens), 5),
            f"library_ms{tag}": cuda_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                20),
            f"shape{tag}": shape})
        # What this run's lengths need: a key at or past its clip's length
        # has probability exactly 0 next to any valid key, so neither its
        # products nor its k and v rows are needed; an empty clip averages
        # all S values.  q and the output count in full.
        n_keys = int(torch.where(valid, lens, torch.full_like(lens, s)).sum())
        r.update(bound(4.0 * 16 * s * 64 * n_keys,
                       2 * tensor_bytes(q) + 2 * 16 * 64 * q.element_size() * n_keys
                       + 4 * lens.numel(), tag))
        q, k = 3 * q, 3 * k
        r2 = _compare("flash_attention_varlen",
                      flash_attention(q, k, v, key_lens=lens)[valid],
                      reference_attention_varlen(q, k, v, lens)[valid])
        r.update({f"max_abs_err_sharp{tag}": r2["max_abs_err"],
                  f"mean_abs_err_sharp{tag}": r2["mean_abs_err"]})
        del q, k, v, got, want, mask
    res["flash_attention_varlen"] = r
    torch.cuda.synchronize()

    def ffn_args(tokens_shape, d, m, x_dtype, bias_dtype):
        return (randn(*tokens_shape, d, dtype=x_dtype),
                1.0 + randn(d, std=0.1), randn(d, std=0.1),
                randn(m, d, std=d ** -0.5, dtype=bf),
                randn(m, std=0.1, dtype=bias_dtype),
                randn(d, m, std=m ** -0.5, dtype=bf),
                randn(d, std=0.1, dtype=bias_dtype))

    def ffn_bound(args, tag=""):
        x, w1 = args[0], args[3]
        return bound(4.0 * (x.numel() // x.shape[-1]) * w1.numel(),
                     tensor_bytes(*args) + tensor_bytes(x), tag)

    # ViViT FFN: bf16 stream (8, 1569, 768), f32 LN params and biases.
    reseed()
    args = ffn_args((8, 1569), 768, 3072, bf, torch.float32)
    got = fused_ffn(*args)
    want = ffn_reference(*args)
    torch.cuda.synchronize()
    r = _compare("fused_ffn", got, want)
    _same_bits("fused_ffn", got, fused_ffn(*args))
    r["plan"] = list(fused_ffn.last_plan)
    r["ms"] = cuda_ms(lambda: fused_ffn(*args), 20)
    r["plain_ms"] = cuda_ms(lambda: ffn_reference(*args), 5)
    r["library_ms"] = None          # no single PyTorch call computes it
    r["four_call_ms"] = four_call_ms(*args, 20)
    r["shape"] = "x (8,1569,768) bf16, M 3072"
    r.update(ffn_bound(args))
    # W2V2 FFN: f32 stream over bf16 weights and biases; a 3 s clip (serving),
    # the two extraction forwards (full grids), and the other grid plans a
    # serving request reaches: a 10 s and a 2 s piece in one batch (998
    # frames), 1,500 frames (five windows of up to 6 s) and 65 frames, one
    # row past a 64-row tile; and the prep chain's extraction forward (64
    # clips of up to 3 s).
    t3 = feat_extract_output_length(cfg, 48000)
    # The last four draw from seeds outside the sequence, so that the cases
    # after them keep the data they had before these were added.
    for tag, tol, shape, iters, seed in (
            ("_w2v2", "fused_ffn_w2v2", (1, t3), 50, None),
            ("_w2v2_extract", "fused_ffn_w2v2_extract", (64, t5), 10, None),
            ("_w2v2_extract_10s", "fused_ffn_w2v2_extract", (64, t10), 5, None),
            ("_w2v2_2x10s", "fused_ffn_w2v2", (2, t10), 50, 10 ** 6 + 1),
            ("_w2v2_1500", "fused_ffn_w2v2", (1, 1500), 50, 10 ** 6 + 2),
            ("_w2v2_ragged", "fused_ffn_w2v2", (1, 65), 50, 10 ** 6 + 3),
            ("_w2v2_prep", "fused_ffn_w2v2_extract", (64, t3), 10, 10 ** 6 + 4)):
        if seed is None:
            reseed()
        else:
            g.manual_seed(seed)
        args = ffn_args(shape, 1024, 4096, torch.float32, bf)
        got = fused_ffn(*args)
        want = ffn_reference(*args)
        torch.cuda.synchronize()
        r2 = _compare("fused_ffn", got, want, key=tol)
        _same_bits("fused_ffn", got, fused_ffn(*args))
        r[f"plan{tag}"] = list(fused_ffn.last_plan)
        r.update({f"max_abs_err{tag}": r2["max_abs_err"],
                  f"mean_abs_err{tag}": r2["mean_abs_err"],
                  f"ms{tag}": cuda_ms(lambda: fused_ffn(*args), iters),
                  f"plain_ms{tag}": cuda_ms(lambda: ffn_reference(*args), 5),
                  f"shape{tag}": f"x {(*shape, 1024)} f32, M 4096"})
        if tag == "_w2v2_extract":
            r[f"four_call_ms{tag}"] = four_call_ms(*args, iters)
        r.update(ffn_bound(args, tag))
    res["fused_ffn"] = r
    del args, got, want

    # Conv feature encoder, both routes, on (4, 48000) f32 (serving), on
    # the two extraction forwards' waveform batches and on the prep chain's
    # (64, 48000).
    reseed()
    conv_args = _conv_layer_args(cfg, randn)
    r, rl = {}, {}
    for tag, shape, iters in (("", (4, 48000), 20),
                              ("_extract", EXTRACT_WAVES[0], 5),
                              ("_extract_10s", EXTRACT_WAVES[1], 3),
                              ("_prep", PREP_WAVES, 5)):
        wave = randn(*shape)
        t_out = feat_extract_output_length(cfg, shape[1])
        got = fused_conv_encoder(wave, *conv_args, cfg)
        per_layer = fused_conv_encoder(wave, *conv_args, cfg, mega=False)
        want = conv_encoder_reference(wave, *conv_args, cfg)
        torch.cuda.synchronize()
        for out in (got, per_layer):
            if out.shape != (shape[0], t_out, 512):
                raise AssertionError(f"fused_conv_encoder shape {tuple(out.shape)}")
        log(f"conv encoder on {shape}: mega=True vs plain, mega=False vs plain, "
            "mega=False vs mega=True")
        # Each route's distance from the f32 path, logged before the
        # comparisons so that a failing one still shows it.
        exact = conv_encoder_reference(
            wave, *conv_args, dataclasses.replace(cfg, compute_dtype="float32"))
        (e_mega, m_mega), (e_layer, m_layer), (e_plain, m_plain) = (
            (float(d.mean()), float(d.max())) for d in
            ((out.float() - exact).abs() for out in (got, per_layer, want)))
        log(f"conv encoder vs the f32 path, mean / max abs err: mega=True "
            f"{e_mega:.3e} / {m_mega:.3e}, mega=False {e_layer:.3e} / "
            f"{m_layer:.3e}, plain bf16 version {e_plain:.3e} / {m_plain:.3e}")
        tol = {"_extract_10s": "fused_conv_encoder_10s",
               "_prep": "fused_conv_encoder_prep"}.get(tag, "fused_conv_encoder")
        r2 = _compare("fused_conv_encoder", got, want, key=tol)
        r3 = _compare("fused_conv_encoder", per_layer, want, key=tol)
        r4 = _compare("fused_conv_encoder", per_layer, got, key=tol)
        _same_bits("fused_conv_encoder", got, fused_conv_encoder(wave, *conv_args, cfg))
        if max(e_mega, e_layer) > CONV_F32_FACTOR * e_plain:
            raise AssertionError("a conv route is further from the f32 path "
                                 "than the plain version")
        del exact
        r.update(_conv_bound(cfg, wave, conv_args, got, tag))
        r.update({f"max_abs_err{tag}": r2["max_abs_err"],
                  f"mean_abs_err{tag}": r2["mean_abs_err"],
                  f"ms{tag}": cuda_ms(
                      lambda: fused_conv_encoder(wave, *conv_args, cfg), iters),
                  f"plain_ms{tag}": cuda_ms(
                      lambda: conv_encoder_reference(wave, *conv_args, cfg), 3),
                  f"shape{tag}": f"wave {shape} f32 -> ({shape[0]},{t_out},512) bf16"})
        r.update(conv_layers_report(dev, cfg, wave, conv_args, iters, tag))
        rl.update({f"route_max_abs_err{tag}": r3["max_abs_err"],
                   f"route_vs_mega_max_abs_err{tag}": r4["max_abs_err"],
                   f"route_ms{tag}": cuda_ms(
                       lambda: fused_conv_encoder(wave, *conv_args, cfg,
                                                  mega=False), iters)})
        log(f"time conv encoder on {shape}: mega=True {r['ms' + tag]:.4f} ms, "
            f"mega=False {rl['route_ms' + tag]:.4f} ms, plain "
            f"{r['plain_ms' + tag]:.4f} ms")
        del wave, got, per_layer, want
    r["library_ms"] = None          # seven conv + LayerNorm + GELU calls
    res["fused_conv_encoder"] = r
    torch.cuda.synchronize()

    # The per-layer route's two kernels at every shape the two extraction
    # forwards give them: layer-0 patches (K = 16), then the stride-merged
    # view of each later layer's input, its length padded to even.
    def layer_vectors():
        return randn(512, std=0.1), 1.0 + randn(512, std=0.1), randn(512, std=0.1)

    def even(n):
        return n + n % 2

    gemm_cases, k3_cases = [], []       # (tag, merged or patch rows, K, t_pad)
    for sec, (rows, samples) in zip(("", "_10s"), EXTRACT_WAVES):
        lengths = _layer_lengths(cfg, samples)
        gemm_cases.append((f"_l0{sec}", even(lengths[0]), 16, even(lengths[0])))
        for i, kk in enumerate(cfg.conv_kernels[1:], start=1):
            (gemm_cases if kk == 2 else k3_cases).append(
                (f"_l{i}{sec}", even(lengths[i - 1]) // 2, 1024, even(lengths[i])))
    # Every layer length above is odd.  An even one as well (16,001 frames
    # in, 8,000 out): its last row reads a merged row that exists.
    k3_cases.append(("_even", 8001, 1024, 8000))
    # The first case of each kernel gives the row's main numbers.
    gemm_cases[0] = ("",) + gemm_cases[0][1:]
    k3_cases[0] = ("",) + k3_cases[0][1:]

    r = dict(rl)
    for tag, rows, kdim, t_pad in gemm_cases:
        reseed()
        x = randn(64, rows, kdim, dtype=bf)
        w = randn(kdim, 512, std=kdim ** -0.5, dtype=bf)
        vecs = layer_vectors()
        shape = f"x (64,{rows},{kdim}) bf16 -> (64,{t_pad},512)"
        log(f"kernel conv_gemm_ln_gelu, {shape}")
        got = _call_gemm(x, w, *vecs, t_pad)
        grid = _call_gemm.last_grid
        want = gemm_ln_gelu_reference(x, w, *vecs, t_pad)
        torch.cuda.synchronize()
        r2 = _compare("conv_gemm_ln_gelu", got, want, key="conv_layer")
        _same_bits("conv_gemm_ln_gelu", got, _call_gemm(x, w, *vecs, t_pad))
        log(f"kernel conv_gemm_ln_gelu: grid {grid} = {grid[0] * grid[1]} blocks, "
            f"{'the wgmma body' if kdim >= 64 else 'the CUDA-core kernel'} (K {kdim})")
        r.update(bound(2.0 * 64 * t_pad * kdim * 512, tensor_bytes(x, w, got, *vecs),
                       tag))
        # The same layer as three library calls on the unmerged input: layer
        # 0 over a waveform whose stride-5 windows are the patches (its
        # first 10 taps), a kernel-2 layer over the (64, 2 rows, 512)
        # activation with the (512, 512, 2) weight whose taps are W's halves.
        if kdim == 16:
            x_cf = randn(64, 1, 5 * (t_pad - 1) + 10)
            weight = w[:10].t().unsqueeze(1)
            stride = 5
        else:
            x_cf = x.view(64, 2 * rows, 512).transpose(1, 2)
            weight = torch.stack([w[:512].t(), w[512:].t()], dim=-1)
            stride = 2
        r[f"three_call_ms{tag}"] = three_call_ms(x_cf, weight, *vecs, stride, 10)
        del x_cf
        r.update({f"max_abs_err{tag}": r2["max_abs_err"],
                  f"mean_abs_err{tag}": r2["mean_abs_err"],
                  f"ms{tag}": cuda_ms(lambda: _call_gemm(x, w, *vecs, t_pad), 20),
                  # The launch alone, from a torch.profiler trace: events
                  # around a ctypes call also count the host's time.
                  f"device_ms{tag}": kernel_device_ms(
                      lambda: _call_gemm(x, w, *vecs, t_pad), "gemm", 10, 1)[0],
                  f"plain_ms{tag}": cuda_ms(
                      lambda: gemm_ln_gelu_reference(x, w, *vecs, t_pad), 3),
                  f"shape{tag}": shape})
        del x, got, want
    r["library_ms"] = None          # matmul + LayerNorm + GELU: three calls
    res["conv_gemm_ln_gelu"] = r

    r = {}
    for tag, rows, kdim, t_pad in k3_cases:
        reseed()
        xm = randn(64, rows, kdim, dtype=bf)
        w01 = randn(1024, 512, std=1536 ** -0.5, dtype=bf)
        w2 = randn(512, 512, std=1536 ** -0.5, dtype=bf)
        vecs = layer_vectors()
        shape = f"xm (64,{rows},{kdim}) bf16 -> (64,{t_pad},512)"
        log(f"kernel conv_k3_ln_gelu, {shape}")
        got = _call_k3(xm, w01, w2, *vecs, t_pad)
        want = k3_ln_gelu_reference(xm, w01, w2, *vecs, t_pad)
        torch.cuda.synchronize()
        r2 = _compare("conv_k3_ln_gelu", got, want, key="conv_layer")
        _same_bits("conv_k3_ln_gelu", got, _call_k3(xm, w01, w2, *vecs, t_pad))
        r.update(bound(2.0 * 64 * t_pad * 1536 * 512,
                       tensor_bytes(xm, w01, w2, got, *vecs), tag))
        # The same layer as three library calls on the unmerged activation:
        # the (512, 512, 3) weight whose taps are [W0; W1] and W2.
        weight = torch.stack([w01[:512].t(), w01[512:].t(), w2.t()], dim=-1)
        r[f"three_call_ms{tag}"] = three_call_ms(
            xm.view(64, 2 * rows, 512).transpose(1, 2), weight, *vecs, 2, 10)
        r.update({f"max_abs_err{tag}": r2["max_abs_err"],
                  f"mean_abs_err{tag}": r2["mean_abs_err"],
                  f"ms{tag}": cuda_ms(
                      lambda: _call_k3(xm, w01, w2, *vecs, t_pad), 10),
                  f"plain_ms{tag}": cuda_ms(
                      lambda: k3_ln_gelu_reference(xm, w01, w2, *vecs, t_pad), 3),
                  f"shape{tag}": shape})
        del xm, got, want
    r["library_ms"] = None          # two matmuls + LayerNorm + GELU
    res["conv_k3_ln_gelu"] = r
    torch.cuda.synchronize()

    for name, r in res.items():
        for tag in sorted({k[len("shape"):] for k in r if k.startswith("shape")}):
            lib = r.get("library_ms" + tag)
            plan = r.get("plan" + tag)
            three = r.get("three_call_ms" + tag)
            four = r.get("four_call_ms" + tag)
            device = r.get("device_ms" + tag)
            log(f"time {name}: kernel {r['ms' + tag]:.4f} ms"
                + (f" ({device:.4f} ms device time)" if device is not None else "")
                + ", plain "
                f"{r['plain_ms' + tag]:.4f} ms, bound {r['bound_ms' + tag]:.4f} ms "
                f"by {r['bound_by' + tag]}"
                + (f", library call {lib:.4f} ms" if lib is not None else "")
                + (f", three library calls {three:.4f} ms" if three is not None else "")
                + (f", four library calls {four:.4f} ms" if four is not None else "")
                + (f", grid plan (rows, D slices, M slices) {tuple(plan)}"
                   if plan else "")
                + f" ({r['shape' + tag]})")
    return res



# The positional conv's shapes: both extraction forwards' (64 rows of the 5
# and 10 s buckets' frames) and the serving requests' (a 3 s clip, a ragged
# 65 frames, five windows of up to 6 s, a 10 s and a 2 s piece).
POS_CONV_SHAPES = ((64, 249), (64, 499), (1, 149), (1, 65), (1, 1500), (2, 499))


def check_pos_conv(dev) -> dict:
    """Phase 3c: the positional-conv kernel against its plain version at
    POS_CONV_SHAPES, timed beside its bound, the plain version and cuDNN."""
    import torch
    import torch.nn.functional as F

    from mmer_tpu_torch.config import Wav2Vec2Config
    from mmer_tpu_torch.ops.pos_conv import pos_conv_reference, pos_conv_residual
    from mmer_tpu_torch.scripts.timing import kernel_device_ms, tensor_bytes

    cfg = Wav2Vec2Config()
    d, groups, taps = cfg.hidden_dim, cfg.num_conv_pos_embedding_groups, \
        cfg.num_conv_pos_embeddings
    g = torch.Generator(device=dev)
    r = {}
    for i, (rows, frames) in enumerate(POS_CONV_SHAPES):
        g.manual_seed(i)
        weight = torch.randn(d, d // groups, taps, generator=g, device=dev) \
            * (d // groups * taps) ** -0.5
        bias = 0.1 * torch.randn(d, generator=g, device=dev)
        x = torch.randn(rows, frames, d, generator=g, device=dev)
        keep = torch.randint(1, frames + 1, (rows,), generator=g, device=dev)
        keep[0] = frames
        if rows > 1:
            keep[-1] = 0                    # a fully padded row
        mask = torch.arange(frames, device=dev)[None, :] >= keep[:, None]
        tag = "" if i == 0 else f"_{rows}x{frames}"
        shape = f"x ({rows},{frames},{d}) f32, {groups} groups of {taps} taps"
        log(f"kernel pos_conv, {shape}")
        args = (x, mask, weight, bias, cfg)
        with torch.inference_mode():
            got = pos_conv_residual(*args)
            plan = pos_conv_residual.last_plan
            want = pos_conv_reference(*args)
            torch.cuda.synchronize()
            r2 = _compare("pos_conv", got, want)
            _same_bits("pos_conv", got, pos_conv_residual(*args))
            # cuDNN's grouped conv with the bias, GELU and the residual on
            # operands cast and laid out beforehand: the library's time for
            # the sublayer (the plain version also zeroes, casts and trims).
            xt = x.masked_fill(mask[:, :, None], 0.0).to(torch.bfloat16).transpose(1, 2)
            wb, bb = weight.to(torch.bfloat16), bias.to(torch.bfloat16)
            trim = taps % 2 == 0

            def library():
                y = F.conv1d(xt, wb, bb, padding=taps // 2, groups=groups)
                return x + F.gelu(y[:, :, :-1] if trim else y).transpose(1, 2).float()

            r.update({f"max_abs_err{tag}": r2["max_abs_err"],
                      f"mean_abs_err{tag}": r2["mean_abs_err"],
                      f"plan{tag}": list(plan),
                      f"ms{tag}": cuda_ms(lambda: pos_conv_residual(*args), 20),
                      f"device_ms{tag}": kernel_device_ms(
                          lambda: pos_conv_residual(*args), "pos_conv_gelu", 10, 1)[0],
                      f"plain_ms{tag}": cuda_ms(lambda: pos_conv_reference(*args), 3),
                      f"library_ms{tag}": cuda_ms(library, 3),
                      f"shape{tag}": shape})
        r.update(bound(2.0 * rows * frames * d * (d // groups) * taps,
                       2 * tensor_bytes(x) + tensor_bytes(mask)
                       + weight.numel() * 2 + d * 2, tag))
        log(f"time pos_conv: kernel {r['ms' + tag]:.4f} ms ({r['device_ms' + tag]:.4f} "
            f"ms device time), plain {r['plain_ms' + tag]:.4f} ms, cuDNN conv + bias "
            f"+ GELU + residual {r['library_ms' + tag]:.4f} ms, bound "
            f"{r['bound_ms' + tag]:.4f} ms by {r['bound_by' + tag]}, plan (tile, "
            f"blocks) {tuple(plan)} ({shape})")
        del x, mask, got, want, xt
    return {"pos_conv": r}


# Plain attention's shapes: the positional conv's, the Wav2Vec2 layers' of
# the same forwards.
PLAIN_ATTENTION_SHAPES = POS_CONV_SHAPES


def check_plain_attention(dev) -> dict:
    """Phase 3d: the plain-attention kernel against its plain version (the
    torch route) at PLAIN_ATTENTION_SHAPES, on q, k, v laid out as the
    separate projections and as the fused one's column slices, timed beside
    its bound, the plain version and ``scaled_dot_product_attention`` (timed
    only); the phase's launches."""
    import torch
    import torch.nn.functional as F

    from mmer_tpu_torch.config import Wav2Vec2Config
    from mmer_tpu_torch.ops.plain_attention import (plain_attention,
                                                    plain_attention_reference)
    from mmer_tpu_torch.scripts.timing import kernel_device_ms, tensor_bytes

    cfg = Wav2Vec2Config()
    d, h = cfg.hidden_dim, cfg.num_heads
    g = torch.Generator(device=dev)
    r = {}
    n0 = plain_attention.launches
    for i, (rows, frames) in enumerate(PLAIN_ATTENTION_SHAPES):
        g.manual_seed(100 + i)
        qkv = torch.randn(rows, frames, 3 * d, generator=g, device=dev).to(torch.bfloat16)
        fused = qkv.split(d, dim=-1)
        q, k, v = (x.contiguous() for x in fused)
        keep = torch.randint(1, frames + 1, (rows,), generator=g, device=dev)
        keep[0] = frames
        if rows > 1:
            keep[-1] = 0                    # a fully padded row
        mask = torch.arange(frames, device=dev)[None, :] >= keep[:, None]
        tag = "" if i == 0 else f"_{rows}x{frames}"
        shape = f"q,k,v ({rows},{frames},{d}) bf16, {h} heads of {d // h}"
        log(f"kernel plain_attention, {shape}")
        args = (q, k, v, mask, h)
        with torch.inference_mode():
            got = plain_attention(*args)
            want = plain_attention_reference(*args)
            torch.cuda.synchronize()
            r2 = _compare("plain_attention", got, want)
            _same_bits("plain_attention", got, plain_attention(*args))
            _same_bits("plain_attention (fused q, k, v slices)", got,
                       plain_attention(*fused, mask, h))
            qh, kh, vh = (x.view(rows, frames, h, d // h).transpose(1, 2) for x in (q, k, v))
            keys = ~mask[:, None, None, :]

            def library():
                return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=keys)

            r.update({f"max_abs_err{tag}": r2["max_abs_err"],
                      f"mean_abs_err{tag}": r2["mean_abs_err"],
                      f"ms{tag}": cuda_ms(lambda: plain_attention(*args), 20),
                      f"device_ms{tag}": kernel_device_ms(
                          lambda: plain_attention(*args), "plain_attention", 10, 1)[0],
                      f"plain_ms{tag}": cuda_ms(lambda: plain_attention_reference(*args), 3),
                      f"library_ms{tag}": cuda_ms(library, 10),
                      f"shape{tag}": shape})
        r.update(bound(4.0 * rows * h * frames * frames * (d // h),
                       tensor_bytes(q, k, v, got) + tensor_bytes(mask), tag))
        log(f"time plain_attention: kernel {r['ms' + tag]:.4f} ms "
            f"({r['device_ms' + tag]:.4f} ms device time), plain "
            f"{r['plain_ms' + tag]:.4f} ms, scaled_dot_product_attention "
            f"{r['library_ms' + tag]:.4f} ms, bound {r['bound_ms' + tag]:.4f} ms "
            f"by {r['bound_by' + tag]} ({shape})")
        del qkv, fused, q, k, v, mask, got, want
    log(f"plain_attention: {plain_attention.launches - n0} launches in the phase")
    return {"plain_attention": r}


def check_probe_kernels(dev) -> dict:
    """``fused_ln_matmul`` and every mode of ``attention_variant`` against
    their plain versions at the profile and probe scripts' shapes."""
    import torch
    import torch.nn.functional as F

    from mmer_tpu_torch.ops.attention_variants import (
        MODES, attention_variant, attention_variant_reference, launch_variant,
        variant_operands)
    from mmer_tpu_torch.ops.flash_attention import flash_attention
    from mmer_tpu_torch.ops.fused_blocks import (LN_EPS, fused_ln_matmul,
                                                 ln_matmul_reference)
    from mmer_tpu_torch.scripts.timing import kernel_device_ms, tensor_bytes

    g = torch.Generator(device=dev)
    bf = torch.bfloat16
    res = {}

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    # LN -> QKV at the profile shape (bf16 stream), and at the Wav2Vec2 width
    # (f32 stream, 4 x 149 frames).
    r = {}
    for tag, seed, shape, d, n, x_dtype, iters in (
            ("", 100, (16, 1569), 768, 2304, bf, 20),
            ("_w2v2", 101, (4, 149), 1024, 3072, torch.float32, 50)):
        g.manual_seed(seed)
        x = randn(*shape, d, dtype=x_dtype)
        ln_w, ln_b = 1.0 + randn(d, std=0.1), randn(d, std=0.1)
        w = randn(n, d, std=d ** -0.5, dtype=bf)
        got = fused_ln_matmul(x, ln_w, ln_b, w)
        want = ln_matmul_reference(x, ln_w, ln_b, w)
        torch.cuda.synchronize()
        if got.shape != (*shape, n) or got.dtype != bf:
            raise AssertionError(f"fused_ln_matmul gave {tuple(got.shape)} "
                                 f"{got.dtype}")
        shape_s = (f"x {(*shape, d)} {str(x_dtype).split('.')[-1]}, w ({n},{d}) "
                   "bf16")
        log(f"kernel fused_ln_matmul, {shape_s}")
        r2 = _compare("fused_ln_matmul", got, want)
        _same_bits("fused_ln_matmul", got, fused_ln_matmul(x, ln_w, ln_b, w))
        plan = fused_ln_matmul.last_plan
        log(f"kernel fused_ln_matmul: grid plan (rows, N slices) {plan}, "
            f"{-(-x.numel() // d // plan[0]) * plan[1]} blocks")
        ln_w_bf, ln_b_bf = ln_w.to(bf), ln_b.to(bf)
        xb = x.to(bf)
        r.update({
            f"max_abs_err{tag}": r2["max_abs_err"],
            f"mean_abs_err{tag}": r2["mean_abs_err"],
            f"ms{tag}": cuda_ms(lambda: fused_ln_matmul(x, ln_w, ln_b, w), iters),
            f"device_ms{tag}": kernel_device_ms(
                lambda: fused_ln_matmul(x, ln_w, ln_b, w), "ln_matmul_kernel", 10, 1)[0],
            f"plain_ms{tag}": cuda_ms(
                lambda: ln_matmul_reference(x, ln_w, ln_b, w), 5),
            # Not one call but two (LayerNorm, then the product), in bf16.
            f"two_call_ms{tag}": cuda_ms(
                lambda: F.linear(F.layer_norm(xb, (d,), ln_w_bf, ln_b_bf, LN_EPS),
                                 w), iters),
            f"shape{tag}": shape_s})
        r.update(bound(2.0 * x.numel() * n, tensor_bytes(x, ln_w, ln_b, w, got), tag))
        del x, w, got, want, xb
    r["library_ms"] = None          # LayerNorm and the product are two calls
    res["fused_ln_matmul"] = r
    for tag in ("", "_w2v2"):
        log(f"time fused_ln_matmul: kernel {r['ms' + tag]:.4f} ms ({r['device_ms' + tag]:.4f} "
            f"ms device time), LayerNorm + linear in bf16 (two library calls) "
            f"{r['two_call_ms' + tag]:.4f} ms ({r['shape' + tag]})")

    # The attention probe: all seven modes on one (q, k, v).
    b, h, s, d = PROBE_SHAPE
    g.manual_seed(102)
    q, k, v = (randn(b, h, s, d, dtype=bf) for _ in range(3))
    flash = flash_attention(q, k, v)
    # One library call per function: keys at or beyond S absent (``full``,
    # ``mxumask``, ``kt``), or, for ``nomask``, the zero-padded keys and
    # values taking part.  No single call computes the three invalid modes.
    kp, vp = (F.pad(t, (0, 0, 0, PROBE_S_PAD - s)) for t in (k, v))
    masked_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)
    padded_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, kp, vp), 20)
    library = {"full": masked_ms, "mxumask": masked_ms, "kt": masked_ms,
               "nomask": padded_ms}
    library_nomask = F.scaled_dot_product_attention(q, kp, vp)
    del kp, vp
    for mode in MODES:
        name = f"attention_variant[{mode}]"
        # The result comes through the public wrapper; the timing below is of
        # the launch alone over pre-staged operands, as the probe script's.
        got = attention_variant(q, k, v, mode, PROBE_S_PAD)
        ops = variant_operands(q, k, v, mode, PROBE_S_PAD)
        _same_bits(name, got, launch_variant(mode, *ops, PROBE_S_PAD))
        torch.cuda.synchronize()

        def plain(parts=False):
            # Two batch elements at a time: a (2,12,1664,1664) f32 score
            # matrix is 266 MB, the whole batch's would be 2.1 GB a copy.
            outs = [attention_variant_reference(
                q[i:i + 2], k[i:i + 2], v[i:i + 2], mode, PROBE_S_PAD,
                return_parts=parts) for i in range(0, b, 2)]
            if not parts:
                return torch.cat(outs)
            return tuple(torch.cat(t) for t in zip(*outs))

        want, num, den = plain(parts=True)
        log(f"kernel {name}, q,k,v {PROBE_SHAPE} bf16, keys padded to "
            f"{PROBE_S_PAD}")
        if mode in ("nosoftmax", "kt_nosoftmax"):
            keep = (den.abs() >= DEN_MIN).squeeze(-1)
            share = float(keep.float().mean())
            diff = (got.float() - want.float()).abs()[keep]
            implied = diff * den.abs()[keep]
            mx, mean = float(implied.max()), float(implied.mean())
            tol_max = PRODUCTS_ONLY_TOL[0] * float(num[keep].abs().max())
            tol_mean = PRODUCTS_ONLY_TOL[1] * float(num[keep].abs().mean())
            ok = bool(torch.isfinite(implied).all()) and mx <= tol_max \
                and mean <= tol_mean and share > 0.8
            log(f"kernel {name}: rows with |denominator| >= {DEN_MIN}: "
                f"{100 * share:.2f} % compared; |kernel - plain| * "
                f"|denominator| max {mx:.3e} (tol {tol_max:.3e}) mean "
                f"{mean:.3e} (tol {tol_mean:.3e}) -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain version")
            r = {"max_abs_err": float(diff.max()),
                 "mean_abs_err": float(diff.mean()),
                 "implied_numerator_max_err": mx, "rows_compared": share}
        else:
            r = _compare(name, got, want, key="attention_variant")
            r["rows_compared"] = 1.0
        if mode in ("mxumask", "kt"):
            r2 = _compare(f"{name} vs flash_attention", got, flash,
                          key="attention_variant")
            r["max_abs_diff_vs_flash"] = r2["max_abs_err"]
        if mode == "nomask":
            # The library call over padded keys computes this mode's function.
            log(f"library call for {name}: scaled_dot_product_attention over "
                f"k, v zero-padded to {PROBE_S_PAD} rows, against the plain "
                "version")
            r2 = _compare(f"{name}: library call vs plain", library_nomask,
                          want, key="attention_variant")
            r["library_max_abs_err"] = r2["max_abs_err"]
        r["ms"] = cuda_ms(lambda: launch_variant(mode, *ops, PROBE_S_PAD), 10)
        r["plain_ms"] = cuda_ms(plain, 1, warmup=0)
        r["library_ms"] = library.get(mode)
        r["shape"] = f"q,k,v {PROBE_SHAPE} bf16, s_pad {PROBE_S_PAD}"
        r.update(bound(4.0 * b * h * s * s * d, tensor_bytes(*ops, got)))
        res[name] = r
        log(f"time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms"
            + (f", library call {r['library_ms']:.4f} ms"
               if r["library_ms"] is not None else ""))
        del ops, got, want, num, den
    del q, k, v, flash, library_nomask
    torch.cuda.synchronize()
    return res


# The threefry kernel's bound: each output word written once, and about 76
# 32-bit integer operations a word (one threefry2x32, 72, and its transform).
# The guide's table gives 67 TFLOP/s of float32 outside the tensor cores: 128
# lanes an SM and clock at 2 operations a fused multiply-add; Hopper has 64
# int32 lanes an SM, so 67e12 / 4 integer operations a second.
THREEFRY_OPS_PER_WORD = 76
INT32_OPS_PER_S = 67e12 / 4
# The random-stream phase's draws, as the trainers make them at
# ModelConfig() width (T = 5): a step at batch 64 (the 11 masks, u and j),
# phase 9's global batch of 256, four seed lanes at 64, and the epoch
# permutation of the 6,796 training rows (two sort-key rounds).
STREAM_STEP_B, STREAM_GLOBAL_B, STREAM_LANES = 64, 256, 4


def random_leaves(spec: dict) -> int:
    """The leaves of a ``jax_init`` spec that draw random bits (normal and
    lecun-normal initializers): one threefry launch each on the card."""
    from mmer_tpu_torch.models.jax_init import Leaf

    return sum(random_leaves(v) if isinstance(v, dict)
               else int(v.init in ("normal", "lecun_normal"))
               for v in spec.values() if isinstance(v, (dict, Leaf)))


def _threefry_case(dev, tag: str, draws, lanes, keys, step) -> dict:
    """One DrawPlan on the card against its plain version on the card: the
    same values, the same bits on a second call, one launch a call; the
    kernel's time, the plain version's and the bound."""
    import torch

    from mmer_tpu_torch.ops import prng
    from mmer_tpu_torch.scripts.timing import (PEAK_BYTES, kernel_device_ms,
                                               tensor_bytes)

    plan = prng.DrawPlan(draws, dev, lanes=lanes)
    before = prng.launch_threefry.launches
    got = plan.draw(keys, step)
    if prng.launch_threefry.launches != before + 1:
        raise AssertionError(f"threefry {tag}: not one launch a draw call")
    want = plan.draw_plain(keys, step)
    err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    again = all(torch.equal(g, h) for g, h in zip(got, plan.draw(keys, step)))
    out_bytes = tensor_bytes(*got)
    # The kernel's device time (torch.profiler: the host's Python around a
    # launch, ~0.2 ms, would otherwise be timed), the call's and the plain
    # version's (CUDA events).
    ms = kernel_device_ms(lambda: plan.draw(keys, step), "threefry_kernel",
                          iters=20, per_call=1)[0]
    call_ms = cuda_ms(lambda: plan.draw(keys, step), iters=50)
    plain_ms = cuda_ms(lambda: plan.draw_plain(keys, step), iters=5, warmup=1)
    t_ops = plan.total * THREEFRY_OPS_PER_WORD / INT32_OPS_PER_S * 1e3
    t_bytes = out_bytes / PEAK_BYTES * 1e3
    log(f"threefry {tag}: {plan.total} words ({out_bytes / 1e6:.3f} MB) in "
        f"{len(plan.table)} segments, {len(plan.work)} work ranges: "
        f"{'bit-equal' if same else 'DIFFERENT'} to "
        f"the plain version, {'the same bits' if again else 'OTHER BITS'} on a "
        f"second call; kernel {ms:.4f} ms (device; the call {call_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, bound "
        f"{max(t_ops, t_bytes):.4f} ms ({'operations' if t_ops >= t_bytes else 'bytes'}"
        f": {t_ops:.4f} ms of integer operations, {t_bytes:.4f} ms of bytes)")
    if not (same and again):
        raise AssertionError(f"threefry {tag}: the kernel disagrees with its "
                             "plain version or with itself")
    return {"max_abs_err": err, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "words": plan.total, "bytes": out_bytes}


def run_random_stream(dev) -> dict:
    """The trainers' random stream on the card: the threefry kernel against
    its plain version at the trainers' draws, one launch a step, JAX's own
    draws from the committed fixture, and the training step's operations
    and time (``scripts/profile_train.py``).  Returns the kernel's line
    fields (the step case's numbers)."""
    import numpy as np

    from mmer_tpu_torch.config import ModelConfig, TrainConfig
    from mmer_tpu_torch.models.fusion import dropout_draws
    from mmer_tpu_torch.ops import prng
    from mmer_tpu_torch.scripts import profile_train
    from mmer_tpu_torch.train import keys as train_keys

    t_phase = time.perf_counter()
    cfg, t = ModelConfig(), train_keys.FIXTURE_T
    key = prng.split(prng.PRNGKey(0))[0]

    def step_draws(b):
        return (dropout_draws(cfg, b, t) + [prng.Draw((103,), (b,), "uniform")]
                + prng.permutation_draws((102,), b))

    cases = {
        "step": (step_draws(STREAM_STEP_B), None, [key], 7),
        "global256": (dropout_draws(cfg, STREAM_GLOBAL_B, t), None, [key], 7),
        "lanes": (step_draws(STREAM_STEP_B), STREAM_LANES,
                  [prng.split(prng.PRNGKey(s))[0] for s in range(STREAM_LANES)], 7),
        "permutation": (prng.permutation_draws((1,), train_keys.FIXTURE_ROWS),
                        None, [key], None)}
    res = {name: _threefry_case(dev, name, *args) for name, args in cases.items()}

    # One launch a training step, whatever its draws; an epoch's mixup λ on
    # the host (107 steps at batch 64), one seed and four lanes.
    tcfg = TrainConfig(mixup_alpha=0.4, modality_dropout=0.3)
    steps = -(-train_keys.FIXTURE_ROWS // STREAM_STEP_B)
    lam_ms = {}
    for seeds in ([0], list(range(STREAM_LANES))):
        ks = train_keys.KeySchedule(seeds, "fused", cfg, tcfg, STREAM_STEP_B, t,
                                    dev, lanes=len(seeds) > 1)
        for _ in range(2):
            ks.begin_epoch(train_keys.FIXTURE_ROWS, steps)
        lam_ms[len(seeds)] = ks.lambda_ms
        before = prng.launch_threefry.launches
        ks.draw()
        if prng.launch_threefry.launches != before + 1:
            raise AssertionError("a training step took more than one threefry "
                                 "launch")
    log(f"random stream: an epoch's mixup weights ({steps} steps) on the host: "
        + "; ".join(f"{n} seed(s) {', '.join(f'{x:.2f}' for x in v)} ms"
                    for n, v in lam_ms.items()))

    # JAX's own draws (the committed fixture, written on the CPU by jax).
    fx = np.load(train_keys.DRAWS_FIXTURE)
    drawn = train_keys.fixture_draws(dev, fx)
    bad = [k for k, (g, w) in drawn.items() if not np.array_equal(g, w)]
    kinds = sorted({k.rsplit("/", 1)[-1].rstrip("0123456789") for k in drawn})
    log(f"random stream: {len(drawn)} arrays ({sum(w.size for _, w in drawn.values())}"
        f" values: {', '.join(kinds)}) of the fixture's cases "
        f"{sorted(train_keys.FIXTURE_CASES)} drawn on the card: "
        f"{'all equal to JAX' if not bad else f'{len(bad)} DIFFER, e.g. {bad[:3]}'}")
    if bad:
        raise AssertionError("the card's draws are not JAX's")

    # The training step at full width: device operations, busy time, idle
    # share (PERF.md: 737 operations and 14.481 ms a step before the stream).
    prof = profile_train.main([])
    if prof["threefry_launches"] != prof["profiled_steps"] + 1:
        raise AssertionError("the profiled steps did not draw one threefry "
                             "launch each (and one for the shuffle)")
    log(f"random stream: phase {time.perf_counter() - t_phase:.2f} s wall")
    return {**{k: v for k, v in res["step"].items() if k not in ("words", "bytes")},
            "cases": {name: {k: r[k] for k in ("ms", "call_ms", "plain_ms",
                                               "bound_ms", "bound_by", "words",
                                               "bytes")}
                      for name, r in res.items()},
            "train_step": {k: prof[k] for k in ("step_ms", "device_busy_ms_per_step",
                                                "idle_share", "device_ops_per_step")},
            "lambda_ms_an_epoch": {str(n): v[-1] for n, v in lam_ms.items()}}


def run_profile_scripts() -> dict:
    """The profile and probe scripts through their ``main``, then the
    ViViT and Wav2Vec2 component profiles; returns the launch counts of
    those runs."""
    from mmer_tpu_torch.ops.attention_variants import MODES, VALID_MODES
    from mmer_tpu_torch.scripts import probe_attn, profile_fused_blocks
    from mmer_tpu_torch.scripts.timing import ROUNDS

    inputs = 3
    passes = inputs * (1 + ROUNDS)          # one warm-up pass, then ROUNDS
    reset_launches()
    rows = profile_fused_blocks.main(["--inputs", str(inputs)])
    rows += probe_attn.main(["--inputs", str(inputs)])
    launches = read_launches()
    for row in rows:
        if not (row["ms"] > 0 and row["device"] != "cpu"):
            raise AssertionError(f"profile row {row} is not a device time")
    # Each valid mode is also run once against flash_attention, which is
    # itself launched once for that comparison and by every ``full`` call.
    variant = {m: passes + (m in VALID_MODES) for m in MODES}
    expected = {**{k: 0 for k in launches},
                "fused_ln_matmul": passes, "fused_ffn": passes,
                "flash_attention": 1 + variant["full"],
                **{f"attention_variant[{m}]": n for m, n in variant.items()}}
    log(f"profile scripts: launch counts {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError("the profile and probe scripts did not launch the "
                             "kernels as expected")

    # The component profiles at full width (ViViT-B at B = 16, Wav2Vec2-large
    # at 64 x 4 s), on kernel rows 1-3: each leg's calls are a warm-up pass,
    # ROUNDS timed passes and one traced pass over its inputs.
    from mmer_tpu_torch.config import ViViTConfig, Wav2Vec2Config
    from mmer_tpu_torch.scripts import profile_vivit, profile_w2v2

    depth, layers = ViViTConfig().depth, Wav2Vec2Config().num_layers
    convs = len(Wav2Vec2Config().conv_dims)     # a launch a layer
    reset_launches()
    t0 = time.perf_counter()
    legs = (profile_vivit.main(["--inputs", str(inputs)])
            + profile_w2v2.main(["--inputs", str(inputs)]))
    profiles_s = time.perf_counter() - t0
    comp = read_launches()
    # Kernel launches of one call of each leg (ViViT legs first).
    per_call = [{"flash_attention": depth, "fused_ffn": depth}, {},
                {"flash_attention": 1}, {}, {"fused_ffn": depth},
                {"fused_conv_encoder": convs, "fused_ffn": layers, "pos_conv": 1,
                 "plain_attention": layers},
                {"fused_conv_encoder": convs},
                {"fused_ffn": layers, "pos_conv": 1, "plain_attention": layers}]
    want = {k: 0 for k in comp}
    for row, kernels_of in zip(legs, per_call):
        for k, n in kernels_of.items():
            want[k] += row["calls"] * n
    for row in legs:
        log(f"component profile: {row['name']}: {row['ms']:.4f} ms, "
            f"{row['tflops']:.2f} TFLOP/s ({100 * row['peak_share']:.2f} % of "
            f"989), device busy {row['device_busy_ms']:.4f} ms, idle share "
            f"{row['idle_share']:.4f}, {row['device_ops']:.0f} device operations")
        if not (row["ms"] > 0 and row["device"] != "cpu"
                and 0 < row["device_busy_ms"]):
            raise AssertionError(f"component profile {row['name']}: no device time")
    log(f"component profiles: {profiles_s:.2f} s wall; launch counts {comp}, "
        f"expected {want}")
    if comp != want:
        raise AssertionError("the component profiles did not launch rows 1-3 as "
                             "expected")
    return {k: launches[k] + comp[k] for k in launches}


# Phase 6b: the conv-encoder profiles and the extractor A/B probes.
def run_component_probes() -> dict:
    """The conv-encoder profiles and the four extractor A/B probes through
    their ``main`` at full width: every row a device time (the pipeline
    probe's wall-clock calls on the card excepted), exact launches of
    rows 1-6 per script, the conv routes within the conv bound of the plain
    route, flash against plain attention and fused against separate q/k/v
    within ``EMBED_REL_L2`` a clip, the pipelined extraction bit-identical to
    the serial one.  Returns the phase's launches (threefry's included)."""
    from mmer_tpu_torch.config import ViViTConfig, Wav2Vec2Config
    from mmer_tpu_torch.ops import prng
    from mmer_tpu_torch.scripts import (probe_extract_pipeline, probe_vivit_b32,
                                        probe_w2v2_flash, probe_w2v2_qkv,
                                        profile_conv_pyramid, profile_cp_layers)

    wcfg, depth = Wav2Vec2Config(), ViViTConfig().depth
    convs, layers = len(wcfg.conv_dims), wcfg.num_layers
    k3 = sum(k == 3 for k in wcfg.conv_kernels)
    encoder = {"fused_conv_encoder": convs, "fused_ffn": layers, "pos_conv": 1}
    plain = {**encoder, "plain_attention": layers}     # the default route
    vivit = {"flash_attention": depth, "fused_ffn": depth}
    # script, arguments, the kernel launches of one call of each row's
    # function (None: the row makes no call).
    runs = [
        (profile_conv_pyramid, [], lambda row: {
            "conv plain": {}, "full plain": {}, "full kernels": plain,
            "conv layers": {"conv_gemm_ln_gelu": convs - k3, "conv_k3_ln_gelu": k3},
            "conv mega": {"fused_conv_encoder": convs}}[row["name"]]),
        (profile_cp_layers, [], lambda row: (
            {"conv_k3_ln_gelu": 1} if "(k3)" in row["name"]
            else {"conv_gemm_ln_gelu": 1})),
        (probe_w2v2_flash, [], lambda row: (
            {**encoder, "flash_attention_varlen": layers}
            if row["name"] == "flash-attn" else plain)),
        (probe_w2v2_qkv, [], lambda row: plain),
        (probe_vivit_b32, [], lambda row: vivit),
        (probe_extract_pipeline, [], None),
    ]
    t_phase = time.perf_counter()
    threefry0 = prng.launch_threefry.launches
    total, results = {k: 0 for k in read_launches()}, {}
    for script, argv, per_call in runs:
        name = script.__name__.rsplit(".", 1)[1]
        reset_launches()
        t0 = time.perf_counter()
        rows = script.main(argv)
        wall = time.perf_counter() - t0
        got = read_launches()
        want = {k: 0 for k in got}
        if per_call is None:
            # A warm-up block, then each loop shape's calls of six blocks.
            blocks = 1 + 2 * probe_extract_pipeline.REPS * probe_extract_pipeline.N_BLOCKS
            for k, n in vivit.items():
                want[k] += blocks * n
        else:
            for row in rows:
                for k, n in per_call(row).items():
                    want[k] += row["calls"] * n
        log(f"component probes: {name}: {wall:.2f} s wall; launches "
            f"{ {k: v for k, v in got.items() if v} }, expected "
            f"{ {k: v for k, v in want.items() if v} }")
        for row in rows:
            # The pipeline probe times the host's wall clock on purpose: what
            # it measures is host staging overlapped with the card's work.
            host_ok = per_call is None and row.get("clock") == "host"
            if "ms" in row and not (row["ms"] > 0 and row["device"] != "cpu"
                                    and (host_ok or "clock" not in row)):
                raise AssertionError(f"{name}: row {row} is not a time on the "
                                     "card's clock")
        if got != want:
            raise AssertionError(f"{name} did not launch the kernels as expected")
        for k, v in got.items():
            total[k] += v
        results[name] = rows

    conv = {r["name"]: r for r in results["profile_conv_pyramid"]}
    tol = TOLERANCES["fused_conv_encoder_10s"][0]
    for route in ("conv layers", "conv mega"):
        r = conv[route]
        log(f"component probes: {route}: {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}, max |diff| "
            f"{r['max_abs_diff']:.4f} from the plain route (limit {tol})")
        if not r["max_abs_diff"] <= tol:
            raise AssertionError(f"{route} is not within the conv bound of the "
                                 "plain route")
    for name in ("probe_w2v2_flash", "probe_w2v2_qkv"):
        base, other = results[name]
        log(f"component probes: {name}: {base['name']} {base['ms']:.4f} ms "
            f"({base['clips_per_s']:.1f} clips/s), {other['name']} "
            f"{other['ms']:.4f} ms ({other['clips_per_s']:.1f} clips/s), "
            f"{base['ms'] / other['ms']:.3f}x; largest rel-L2 of a clip "
            f"{other['clip_rel_l2_max']:.3e} (limit {EMBED_REL_L2}), max "
            f"|diff| {other['max_abs_diff']:.3e}")
        if not other["clip_rel_l2_max"] <= EMBED_REL_L2:
            raise AssertionError(f"{name}: the two variants disagree")
    pipe = results["probe_extract_pipeline"][-1]
    if not pipe["bit_identical"]:
        raise AssertionError("pipeline=True gave other bits than pipeline=False")
    total["threefry"] = prng.launch_threefry.launches - threefry0
    phase_s = time.perf_counter() - t_phase
    log(f"component probes: phase {phase_s:.2f} s wall; launches {total}")
    return total


# Phase 6c: the int8 path (csrc/qdot.cu, the port's own kernel: JAX lets XLA
# compile its int8 dot_general and the quantize around it, no Pallas kernel).
INT8_SOURCES = {
    "row_quant": "mmer_tpu/ops/quant.py:36 (qdot's dynamic per-row quantize, "
                 "which XLA compiles; not a Pallas kernel)",
    "qdot_int8": "mmer_tpu/ops/quant.py:39 (qdot's int8 dot_general and "
                 "dequantize, which XLA compiles; not a Pallas kernel)",
    "qdot_u8": "mmer_tpu/ops/quant.py:52 (qdot_u8's int8 dot_general and "
               "dequantize, which XLA compiles; not a Pallas kernel)",
}
# row_quant's work a value: an absolute value and a max, a division and a
# rounding, on the CUDA cores: 67e12 float32 operations a second counts a
# fused multiply-add as two, so 33.5e12 instructions.
ROW_QUANT_OPS = 3
F32_INSTR_PER_S = 67e12 / 2
# The int8 forwards' kernel route against their plain route on the card, a
# chunk or a clip (rel-L2).  The int8 products are bit-equal to their plain
# versions (the ViViT leg with plain attention must equal the plain route bit
# for bit), so only attention (ViViT) and the conv encoder (Wav2Vec2) differ,
# each within its own bound; but the next row quantization turns a flipped
# bf16 rounding into a whole int8 step, and over the layers the two routes'
# rounding noise decorrelates: they may sit up to sqrt(2) times an int8
# forward's own distance from the bf16 route apart (~2 % for the ViViT, JAX's
# own figure; on an H100 the ViViT routes read 1.43e-2, Wav2Vec2's 5.0e-3).
INT8_ROUTE_REL_L2 = 0.03
INT8_COS_MIN = 0.999


def check_int8_kernels(dev) -> dict:
    """``row_quant``, ``qdot_int8`` and ``qdot_u8`` against their plain
    versions at every GEMM shape of the int8 forwards: the same bits, the
    same bits on a second call; the kernels' device times (torch.profiler),
    the plain versions', ``torch._int_mm`` with the dequantize as the
    library's, bf16 ``torch.matmul`` at the shape, and the bounds."""
    import torch

    from mmer_tpu_torch.ops import quant
    from mmer_tpu_torch.scripts.probe_int8 import MODEL_GEMMS, library_qdot
    from mmer_tpu_torch.scripts.timing import (PEAK_BYTES, PEAK_INT8_OPS,
                                               bound_ms, kernel_device_ms,
                                               tensor_bytes)

    g = torch.Generator(device=dev)
    res = {"row_quant": {}, "qdot_int8": {}, "qdot_u8": {}}
    for i, (tag, m, k, n, dtype, has_bias) in enumerate(MODEL_GEMMS):
        g.manual_seed(2000 + i)
        w = torch.randn(k, n, generator=g, device=dev) * k ** -0.5
        wq, ws = quant.quantize_weight(w)
        bias = torch.randn(n, generator=g, device=dev) * 0.1 if has_bias else None
        shape = f"({m}, {k}) {dtype} x ({k}, {n})" + (" + bias" if has_bias else "")
        w16 = w.to(torch.bfloat16)
        if dtype == "uint8":
            x = torch.randint(0, 256, (m, k), generator=g, device=dev,
                              dtype=torch.uint8)
            corr = quant.u8_correction(wq)
            x8 = (x.to(torch.int16) - 128).to(torch.int8)
            denom = torch.tensor(255.0, device=dev)

            def call():
                return quant.qdot_u8(x, wq, ws, corr, bias=bias)

            def plain():
                return quant.qdot_u8_reference(x, wq, ws, corr, bias=bias)

            def library():
                return (torch._int_mm(x8, wq) + corr).float() * ws / denom

            gemm_bytes = tensor_bytes(x, wq, ws, corr) + 4 * m * n
            bf16_in = x.to(torch.bfloat16)
        else:
            x = torch.randn(m, k, generator=g, device=dev).to(getattr(torch, dtype))

            def call():
                return quant.qdot(x, wq, ws, bias)

            def plain():
                return quant.qdot_reference(x, wq, ws, bias)

            xq, xs = quant.row_quant(x)
            xq_ref, xs_ref = quant.row_quant_reference(x)
            torch.cuda.synchronize()
            same_rows = torch.equal(xq, xq_ref) and torch.equal(xs, xs_ref)
            rq_again = quant.row_quant(x)
            if not (same_rows and torch.equal(xq, rq_again[0])
                    and torch.equal(xs, rq_again[1])):
                raise AssertionError(f"row_quant{tag}: the kernel disagrees "
                                     "with its plain version or with itself")

            def library():
                return library_qdot(xq, xs, wq, ws)

            gemm_bytes = tensor_bytes(xq, xs, wq, ws) + 4 * m * n
            bf16_in = x.to(torch.bfloat16)
        if bias is not None:
            gemm_bytes += tensor_bytes(bias)
        got = call()
        want = plain()
        torch.cuda.synchronize()
        same, again = torch.equal(got, want), torch.equal(got, call())
        err = float((got - want).abs().max())
        row = "qdot_u8" if dtype == "uint8" else "qdot_int8"
        gemm_ms = kernel_device_ms(call, "int8_gemm_kernel", iters=10,
                                   per_call=1)[0]
        t_gemm, by_gemm = bound_ms(2.0 * m * k * n, gemm_bytes, PEAK_INT8_OPS)
        r = {f"max_abs_err{tag}": err, f"ms{tag}": gemm_ms,
             f"call_ms{tag}": cuda_ms(call, 10),
             f"plain_ms{tag}": cuda_ms(plain, 3, warmup=1),
             f"library_ms{tag}": cuda_ms(library, 10),
             f"bf16_matmul_ms{tag}": cuda_ms(lambda: torch.matmul(bf16_in, w16), 10),
             f"bound_ms{tag}": t_gemm, f"bound_by{tag}": by_gemm,
             f"shape{tag}": shape}
        line = (f"kernel {row}{tag} {shape}: {'bit-equal' if same else 'DIFFERENT'}"
                f" to the plain version (max |diff| {err:.3e}), "
                f"{'the same bits' if again else 'OTHER BITS'} on a second call; "
                f"GEMM {gemm_ms:.4f} ms (device), the call {r[f'call_ms{tag}']:.4f}"
                f" ms, plain {r[f'plain_ms{tag}']:.4f} ms, _int_mm + dequantize "
                f"{r[f'library_ms{tag}']:.4f} ms, bf16 matmul "
                f"{r[f'bf16_matmul_ms{tag}']:.4f} ms, bound {t_gemm:.4f} ms by {by_gemm}")
        if dtype != "uint8":
            rq_ms = kernel_device_ms(call, "row_quant_kernel", iters=10,
                                     per_call=1)[0]
            rq_bytes = tensor_bytes(x, xq, xs)
            t_ops = m * k * ROW_QUANT_OPS / F32_INSTR_PER_S * 1e3
            t_bytes = rq_bytes / PEAK_BYTES * 1e3
            res["row_quant"].update({
                f"max_abs_err{tag}": 0.0, f"ms{tag}": rq_ms,
                f"plain_ms{tag}": cuda_ms(lambda: quant.row_quant_reference(x),
                                          3, warmup=1),
                f"library_ms{tag}": None,
                f"bound_ms{tag}": max(t_ops, t_bytes),
                f"bound_by{tag}": "operations" if t_ops >= t_bytes else "bytes",
                f"shape{tag}": f"({m}, {k}) {dtype}"})
            line += (f"; row_quant {rq_ms:.4f} ms (device), plain "
                     f"{res['row_quant'][f'plain_ms{tag}']:.4f} ms, bound "
                     f"{max(t_ops, t_bytes):.4f} ms, bit-equal")
            del xq, xs, xq_ref, xs_ref, rq_again
        log(line)
        if not (same and again):
            raise AssertionError(f"{row}{tag}: the kernel disagrees with its "
                                 "plain version or with itself")
        res[row].update(r)
        del x, got, want
        torch.cuda.synchronize()
    # Each row's untagged numbers are its first case's.
    for r in res.values():
        first = next(key for key in r if key.startswith("ms_"))[len("ms"):]
        r.update({key: r[f"{key}{first}"] for key in
                  ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                   "bound_by")})
    return res


def run_int8_path(dev) -> dict:
    """Phase 6c: the int8 kernels at every GEMM shape of the int8 forwards
    (:func:`check_int8_kernels`), then ``scripts.probe_int8``,
    ``probe_int8_vivit`` and ``probe_int8_w2v2`` through their ``main`` at full
    width with exact launches; the int8 ViViT and Wav2Vec2 within
    ``INT8_COS_MIN`` of the bf16 route a chunk / clip and their kernel routes
    within ``INT8_ROUTE_REL_L2`` of their plain routes.  Returns the kernels'
    line fields and the probes' launches."""
    from mmer_tpu_torch.config import ViViTConfig, Wav2Vec2Config
    from mmer_tpu_torch.scripts import probe_int8, probe_int8_vivit, probe_int8_w2v2
    from mmer_tpu_torch.scripts.timing import INPUTS

    t_phase = time.perf_counter()
    kernels = check_int8_kernels(dev)
    depth, wcfg = ViViTConfig().depth, Wav2Vec2Config()
    layers, convs = wcfg.num_layers, len(wcfg.conv_dims)
    gemms_v, gemms_w = 4 * depth, 4 * layers + 1
    int8_vivit = {"qdot_u8": 1, "qdot_int8": gemms_v, "row_quant": gemms_v}
    per_call = {
        "probe_int8": lambda row: {
            "int8_kernel": {"qdot_int8": 1},
            "int8_dynamic": {"qdot_int8": 1, "row_quant": 1}}.get(row["leg"], {}),
        "probe_int8_vivit": lambda row: {
            "bf16": {"flash_attention": depth, "fused_ffn": depth},
            "int8-flash": {**int8_vivit, "flash_attention": depth},
            "int8-plain-attn": int8_vivit}[row["name"]],
        "probe_int8_w2v2": lambda row: {
            "bf16": {"fused_conv_encoder": convs, "fused_ffn": layers,
                     "pos_conv": 1, "plain_attention": layers},
            "int8": {"fused_conv_encoder": convs, "qdot_int8": gemms_w,
                     "row_quant": gemms_w, "pos_conv": 1}}[row["name"]]}
    total, results = {k: 0 for k in read_launches()}, {}
    for script in (probe_int8, probe_int8_vivit, probe_int8_w2v2):
        name = script.__name__.rsplit(".", 1)[1]
        reset_launches()
        t0 = time.perf_counter()
        rows = script.main([])
        wall = time.perf_counter() - t0
        got = read_launches()
        want = {k: 0 for k in got}
        for row in rows:
            for k, n in per_call[name](row).items():
                want[k] += row["calls"] * n
        if name == "probe_int8":
            # Each shape's rows are quantized once before the legs.
            want["row_quant"] += INPUTS * len(probe_int8.SHAPES)
        log(f"int8 path: {name}: {wall:.2f} s wall; launches "
            f"{ {k: v for k, v in got.items() if v} }, expected "
            f"{ {k: v for k, v in want.items() if v} }")
        for row in rows:
            if not (row["ms"] > 0 and row["device"] != "cpu"):
                raise AssertionError(f"{name}: row {row} is not a time on the card")
        if got != want:
            raise AssertionError(f"{name} did not launch the kernels as expected")
        for k, v in got.items():
            total[k] += v
        results[name] = rows
    probes = {}
    for name in ("probe_int8_vivit", "probe_int8_w2v2"):
        base = results[name][0]
        for row in results[name][1:]:
            unit = "chunks" if "chunks_per_s" in row else "clips"
            log(f"int8 path: {name} {row['name']}: {row['ms']:.3f} ms "
                f"({row[f'{unit}_per_s']:.1f} {unit}/s) against {base['name']} "
                f"{base['ms']:.3f} ms ({base[f'{unit}_per_s']:.1f} {unit}/s): "
                f"{row['speedup']:.3f}x; cosine {row['cos_min']:.6f}.."
                f"{row['cos_max']:.6f} (limit {INT8_COS_MIN}), rel-L2 mean "
                f"{row['rel_l2_mean']:.4e}; the plain route {row['plain_route_rel_l2']:.3e}"
                f" (limit {0.0 if row['name'] == 'int8-plain-attn' else INT8_ROUTE_REL_L2})")
            limit = 0.0 if row["name"] == "int8-plain-attn" else INT8_ROUTE_REL_L2
            if not (row["finite"] and row["cos_min"] >= INT8_COS_MIN
                    and row["plain_route_rel_l2"] <= limit):
                raise AssertionError(f"{name} {row['name']}: outside its bounds")
            probes[f"{name}/{row['name']}"] = {
                k: row[k] for k in ("ms", f"{unit}_per_s", "speedup", "cos_min",
                                    "rel_l2_mean", "plain_route_rel_l2")}
        probes[f"{name}/{base['name']}"] = {k: base[k] for k in ("ms", f"{unit}_per_s")}
    log(f"int8 path: phase {time.perf_counter() - t_phase:.2f} s wall; launches "
        f"{ {k: v for k, v in total.items() if v} }")
    return {"kernels": kernels, "launches": total, "probes": probes,
            "gemm_rates": {f"{r['name']}": r["tops"] for r in results["probe_int8"]}}


def _make_feature_folders(video_dir: str, audio_dir: str, rng,
                          signal: float = CLASS_SIGNAL) -> int:
    """Feature artifacts of CLASS_COUNTS samples per class from a seed:
    ``*_faces_mp4_features.npy`` (T, 768) float32 with T in 1..5 and
    ``*_voice_mp4_features.npy`` (1024,) float16, unit norm, under CREMA-D
    names and (every fourth sample) RAVDESS names.  Each class has its own
    mean direction, ``signal`` times a unit normal draw per dimension, so
    there is something to learn.  The files are written by eight threads
    (the arrays are drawn first, in one order).  Returns the count."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    writes = []
    emotions = ("NEU", "HAP", "SAD", "ANG", "FEA", "DIS")
    ravdess_code = (1, 3, 4, 5, 6, 7)
    mu_v = rng.normal(size=(len(emotions), 768)).astype(np.float32)
    mu_a = rng.normal(size=(len(emotions), 1024)).astype(np.float32)
    total = 0
    for c, count in enumerate(CLASS_COUNTS):
        lengths = rng.integers(1, 6, size=count)
        video = rng.normal(size=(int(lengths.sum()), 768)).astype(np.float32) \
            + signal * mu_v[c]
        audio = rng.normal(size=(count, 1024)).astype(np.float32) + signal * mu_a[c]
        audio /= np.linalg.norm(audio, axis=1, keepdims=True)
        row = 0
        for i, t in enumerate(lengths):
            key = (f"Actor_{i % 24 + 1:02d}_{i:05d}_02-01-{ravdess_code[c]:02d}"
                   f"-01-01-01-{i % 24 + 1:02d}" if i % 4 == 3 else
                   f"{1000 + i}_S{c}{i % 12:02d}_{emotions[c]}_XX")
            writes.append((os.path.join(
                video_dir, f"{key}_faces_mp4_features.npy"), video[row:row + t]))
            writes.append((os.path.join(
                audio_dir, f"{key}_voice_mp4_features.npy"),
                audio[i].astype(np.float16)))
            row += t
        total += count
    with ThreadPoolExecutor(8) as pool:
        for done in pool.map(lambda job: np.save(*job), writes):
            del done
    return total


def run_training(dev, features: str) -> tuple:
    """The fusion training path at full width on a dataset of real size,
    then serving with the trained head.  The feature folders are written
    under ``features``, where the scale-out phase reads them again.
    Returns the serving request's launches and the run's threefry
    launches."""
    import glob
    import tempfile

    import numpy as np
    import torch

    from mmer_tpu_torch.config import ModelConfig
    from mmer_tpu_torch.models.jax_init import fusion_spec
    from mmer_tpu_torch.ops import prng
    from mmer_tpu_torch.serve.engine import InferenceEngine
    from mmer_tpu_torch.train import cli

    rng = np.random.default_rng(2)
    with tempfile.TemporaryDirectory(prefix="mmer_smoke_train_") as tmp:
        video_dir, audio_dir = (os.path.join(features, d) for d in ("video", "audio"))
        out_dir = os.path.join(tmp, "runs")
        os.makedirs(video_dir)
        os.makedirs(audio_dir)
        t0 = time.perf_counter()
        n = _make_feature_folders(video_dir, audio_dir, rng)
        log(f"training: wrote {n} feature pairs in "
            f"{time.perf_counter() - t0:.2f} s")

        reset_launches()
        prng.launch_threefry.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = cli.main(["--video_feat_dir", video_dir, "--audio_feat_dir",
                        audio_dir, "--batch_size", "64", "--num_epochs",
                        str(TRAIN_EPOCHS), "--lr", "1e-4", "--output_dir",
                        out_dir])
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        threefry = prng.launch_threefry.launches
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        if any(read_launches().values()):
            raise AssertionError(f"training launched kernels: {read_launches()}")

        rows = out.results
        losses = [r["train_loss"] for r in rows]
        wall = out.hyperparameters["train_wall_seconds"]
        n_held_out = math.ceil(0.2 * n)         # the 80/10/10 split's sizes
        n_train, n_test_want = n - n_held_out, math.ceil(0.5 * n_held_out)
        with open(out.results_path) as f:
            saved = json.load(f)
        n_test = int(np.sum(saved["confusion_matrix"]))
        log(f"training: {len(rows)} epochs at batch 64 on {out.hyperparameters['device']}"
            f", train loss {', '.join(f'{x:.4f}' for x in losses)}; val acc "
            f"{rows[-1]['val_acc']:.2f} %, test acc {rows[-1]['test_acc']:.2f} %; "
            f"best epoch {out.best_epoch}; confusion matrix sums to {n_test}")
        log(f"training: {wall:.2f} s for {len(rows)} epochs with their "
            f"evaluations ({wall / len(rows):.3f} s an epoch, "
            f"{len(rows) * n_train / wall:.1f} samples/s over {n_train} "
            f"training samples), {total_s:.2f} s with loading and saving; peak "
            f"device memory {peak:.1f} MiB")
        # The training pass of each epoch alone: epoch 1 carries the
        # libraries' warm-up, the later ones are the warm rate.
        passes = out.train_epoch_seconds
        warm = min(passes[1:])
        log("training: training pass alone "
            + ", ".join(f"{t:.3f}" for t in passes) + " s an epoch; fastest "
            f"warm epoch {warm:.3f} s, {n_train / warm:.1f} samples/s")
        if out.hyperparameters["device"] != "cuda" or len(rows) != TRAIN_EPOCHS:
            raise AssertionError("training did not run its epochs on the card")
        # JAX's stream: the initial weights (a launch a random leaf), then an
        # epoch's shuffle and each step's draws, one launch each.
        steps = -(-n_train // 64)
        init_draws = random_leaves(fusion_spec(ModelConfig(), 768, 1024)[0])
        want = init_draws + TRAIN_EPOCHS * (1 + steps)
        log(f"training: {threefry} threefry launches: {init_draws} for the "
            f"initial weights, {TRAIN_EPOCHS} x ({steps} steps + the "
            f"shuffle) (want {want}); mixup weights "
            f"{out.lambda_ms or 'none (no mixup)'}")
        if threefry != want:
            raise AssertionError("training did not draw one threefry launch a "
                                 "step")
        if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            raise AssertionError(f"train loss not finite and falling: {losses}")
        if not rows[-1]["val_acc"] > 2 * 100.0 / len(CLASS_COUNTS):
            raise AssertionError(f"val accuracy {rows[-1]['val_acc']} is not "
                                 "above chance")
        if n_test != n_test_want or saved["best_model"]["epoch"] != out.best_epoch:
            raise AssertionError("results file disagrees with the run")
        for pattern in ("results_*.json", "best_model_*.pth",
                        "final_model_*.pth", "norm_stats_*.npz"):
            if len(glob.glob(os.path.join(out_dir, pattern))) != 1:
                raise AssertionError(f"training artifact {pattern} missing")

        # Train -> serve: the engine loads the trained head and its stats.
        engine = InferenceEngine(dev, fusion_params_path=out.best_model_path,
                                 norm_stats_path=out.norm_stats_path)
        for key, value in engine.fusion.state_dict().items():
            if not torch.equal(value.cpu(), out.best_params[key].cpu()):
                raise AssertionError(f"engine weight {key} is not the trained one")
        clip = rng.integers(0, 256, size=(2, 32, 224, 224, 3), dtype=np.uint8)
        wave = (rng.normal(size=(48000,)) * 0.1).astype(np.float32)
        reset_launches()
        res = engine.predict_chunks(clip, wave)
        request_launches = read_launches()
        probs = np.asarray(res["probabilities"], np.float64)
        log(f"training: InferenceEngine with the trained head answers "
            f"{res['predicted_label']}, probabilities {np.round(probs, 4).tolist()}")
        if not (np.isfinite(probs).all() and abs(probs.sum() - 1.0) < 1e-4
                and set(engine.norm_stats) == {"video_mean", "video_std",
                                               "audio_mean", "audio_std"}):
            raise AssertionError("serving with the trained head failed")
    return request_launches, threefry


def _per_epoch(tag: str, wall: float, epochs: int, seeds: int,
               n_train: int) -> dict:
    """Seconds an epoch (its evaluations included) and training samples/s
    per seed of one run of ``seeds`` seeds."""
    out = {"s_per_epoch": wall / epochs,
           "samples_per_s_per_seed": n_train * epochs / wall}
    log(f"flagship: {tag}: {wall:.3f} s for {epochs} epochs x {seeds} "
        f"seed(s): {out['s_per_epoch']:.4f} s an epoch, "
        f"{out['samples_per_s_per_seed']:.1f} samples/s a seed, "
        f"{seeds * out['samples_per_s_per_seed']:.1f} in all")
    return out


def run_flagship_chain(dev, request_launches: dict) -> dict:
    """The flagship chain (make_flagship: pool -> teacher -> student) at full
    width on the seeded samples, its gates, serving the flagship, and one
    timing run of four seeds in one call."""
    import tempfile

    import numpy as np
    import torch

    from mmer_tpu_torch.config import ModelConfig
    from mmer_tpu_torch.scripts import make_flagship
    from mmer_tpu_torch.serve.app import resolve_default_fusion
    from mmer_tpu_torch.serve.engine import InferenceEngine
    from mmer_tpu_torch.train.fused import train_many_seeds
    from mmer_tpu_torch.train.loop import train_model

    t_phase = time.perf_counter()
    rng = np.random.default_rng(3)
    with tempfile.TemporaryDirectory(prefix="mmer_smoke_flagship_") as tmp:
        video_dir, audio_dir, out_dir = (os.path.join(tmp, d) for d in
                                         ("video", "audio", "flagship"))
        os.makedirs(video_dir)
        os.makedirs(audio_dir)
        n = _make_feature_folders(video_dir, audio_dir, rng,
                                  FLAGSHIP_CLASS_SIGNAL)

        reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = make_flagship.main([
            "--pool_seeds", "2", "--student_seeds", "2", "--epochs",
            str(FLAGSHIP_EPOCHS), "--seeds_per_call", "2", "--out_dir", out_dir,
            "--video_feat_dir", video_dir, "--audio_feat_dir", audio_dir])
        torch.cuda.synchronize()
        chain_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        if any(read_launches().values()):
            raise AssertionError(f"training launched kernels: {read_launches()}")
        data, splits = res["dataset"]
        n_train = len(splits.train)
        log(f"flagship: make_flagship on {n} samples ({n_train} training) in "
            f"{chain_s:.2f} s; peak device memory {peak:.1f} MiB")

        calls = res["pool"] + [("student", res["students"])]
        for tag, outs in calls:
            for o in outs:
                losses = [r["train_loss"] for r in o["results"]]
                log(f"flagship: {tag} seed {o['seed']}: train loss "
                    + ", ".join(f"{x:.5f}" for x in losses)
                    + f"; best epoch {o['best_epoch']}, val acc "
                    f"{o['results'][o['best_epoch'] - 1]['val_acc']:.2f} %")
                if (len(losses) != FLAGSHIP_EPOCHS
                        or not np.isfinite(losses).all()
                        or not losses[-1] < losses[0]):
                    raise AssertionError(f"{tag} seed {o['seed']}: train loss "
                                         f"not finite and falling: {losses}")
            if outs[0]["results"] == outs[1]["results"]:
                raise AssertionError(f"{tag}: the two seeds of a call agree")
        winning = res["pool"][0][1]
        # The wd3e-3 call: the winning recipe's model and dropout, after the
        # first batched call has paid the process's warm-up.
        times = {"batched_s2": _per_epoch("pool call, wd3e-3 recipe (S = 2)",
                                          res["pool"][2][1][0]["wall_seconds"],
                                          FLAGSHIP_EPOCHS, 2, n_train)}

        # One pool seed alone through the one trainer.
        model_cfg, train_cfg = res["configs"]["winning"]
        solo = train_model(data, splits, model_cfg, train_cfg, batch_size=64,
                           seed=0, verbose=False, device=dev, fused=True)
        times["solo"] = _per_epoch("train_model alone (winning, seed 0)",
                                   solo.hyperparameters["train_wall_seconds"],
                                   FLAGSHIP_EPOCHS, 1, n_train)
        batched = winning[0]
        worst = max(abs(b[k] - s_[k]) / abs(s_[k])
                    for b, s_ in zip(batched["results"], solo.results)
                    for k in ("train_loss", "val_loss"))
        log(f"flagship: seed 0 batched against alone: losses at most "
            f"{worst:.3e} relative apart (limit {FLAGSHIP_LOSS_RTOL}); best "
            f"epoch {batched['best_epoch']} / {solo.best_epoch}")
        if (len(solo.results) != len(batched["results"])
                or worst > FLAGSHIP_LOSS_RTOL
                or solo.best_epoch != batched["best_epoch"]):
            raise AssertionError("the batched seed is not the solo run")

        soft = res["soft_targets"]
        if soft.shape != (n, 6) or np.abs(soft.sum(1) - 1.0).max() > 1e-5:
            raise AssertionError("teacher soft targets are not distributions")
        best = res["flagship"]
        student_acc = best["results"][best["best_epoch"] - 1]["val_acc"]
        manifest = res["manifest"]
        log(f"flagship: teacher of {manifest['teacher_members']} members, "
            f"test F1 {manifest['teacher_test_macro_f1']}; student seed "
            f"{best['seed']} epoch {best['best_epoch']}, val acc "
            f"{student_acc:.2f} %, {manifest['student_val_selected']}")
        if not student_acc > 2 * 100.0 / len(CLASS_COUNTS):
            raise AssertionError(f"student val accuracy {student_acc} is not "
                                 "above twice chance")
        with open(os.path.join(REPO, "artifacts", "flagship",
                               "manifest.json")) as f:
            reference = json.load(f)
        with open(os.path.join(out_dir, "manifest.json")) as f:
            written = json.load(f)
        if (sorted(os.listdir(out_dir)) != ["flagship.msgpack", "manifest.json",
                                            "norm_stats.npz"]
                or written.keys() != reference.keys()):
            raise AssertionError("flagship artifacts or manifest keys differ")

        # Serve the flagship as a bare server start would find it.
        ckpt, ns, cfg_dict = resolve_default_fusion(out_dir)
        if ckpt != os.path.join(out_dir, "flagship.msgpack") or ns is None:
            raise AssertionError(f"resolve_default_fusion found {ckpt}, {ns}")
        engine = InferenceEngine(dev, model_cfg=ModelConfig(**cfg_dict),
                                 fusion_params_path=ckpt, norm_stats_path=ns)
        for key, value in engine.fusion.state_dict().items():
            if not torch.equal(value, best["best_params"][key]):
                raise AssertionError(f"served weight {key} is not the student's")
        clip = rng.integers(0, 256, size=(2, 32, 224, 224, 3), dtype=np.uint8)
        wave = (rng.normal(size=(48000,)) * 0.1).astype(np.float32)
        reset_launches()
        answer = engine.predict_chunks(clip, wave)
        launches = read_launches()
        probs = np.asarray(answer["probabilities"], np.float64)
        log(f"flagship: the served flagship answers {answer['predicted_label']}, "
            f"probabilities {np.round(probs, 4).tolist()}; launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        if not (np.isfinite(probs).all() and abs(probs.sum() - 1.0) < 1e-4):
            raise AssertionError("the served flagship's probabilities")
        rows_1_3 = ("fused_ffn", "flash_attention", "fused_conv_encoder")
        if launches != request_launches or not all(launches[k] for k in rows_1_3):
            raise AssertionError(f"request launches {launches} differ from the "
                                 f"training phase's {request_launches}")

        # Timing: four seeds in one short call.
        t0 = time.perf_counter()
        four = train_many_seeds(data, splits, model_cfg,
                                dataclasses.replace(train_cfg, num_epochs=2),
                                64, seeds=[0, 1, 2, 3], seeds_per_call=4,
                                verbose=False, device=dev)
        times["batched_s4"] = _per_epoch("train_many_seeds (S = 4)",
                                         four[0]["wall_seconds"], 2, 4,
                                         n_train)
        log(f"flagship: S = 4 call {time.perf_counter() - t0:.2f} s with set-up")
    phase_s = time.perf_counter() - t_phase
    log(f"flagship: phase {phase_s:.2f} s wall")
    return {"times": times, "peak_mib": peak, "phase_s": phase_s,
            "batched_vs_solo_rel": worst}


# Phase 8b: the quality scripts at 1 epoch on the training phase's folders.
QUALITY_ARGS = {
    "sweep": ["--epochs", "1"],
    "quality_sweep": ["--epochs", "1"],
    "probe_recipe_sweep_r4": ["--only", "baseline", "--seeds", "2",
                              "--seeds_per_call", "2", "--epochs", "1"],
    "probe_ensemble": ["--seeds", "2", "--seeds_per_call", "2", "--epochs", "1"],
    "probe_diverse_ensemble": ["--seeds", "2", "--seeds_per_call", "2",
                               "--epochs", "1", "--greedy"],
    # Three of the five arms, each opt-in alone and the baseline: phases 6b
    # and 8b share a 180 s budget, and with all five they read 139.7-169.4 s
    # on an H100.
    "probe_mixup_quality": ["--seeds", "2", "--seeds_per_call", "2",
                            "--epochs", "1", "--arms",
                            "baseline,mixup0.2,mdrop0.2"],
    "probe_feature_noise_quality": ["--seeds", "2", "--epochs", "1",
                                    "--levels", "0,0.01"],
    "probe_distill": ["--pool_seeds", "2", "--student_seeds", "2",
                      "--seeds_per_call", "2", "--epochs", "1", "--teacher_k",
                      "4", "--grid", "0.5:1"],
}


def _check_summary(name: str, value, key: str = "") -> int:
    """Every number of a quality script's summary finite, every F1 in [0, 1];
    returns the count of F1 values seen."""
    if isinstance(value, dict):
        return sum(_check_summary(name, v, str(k)) for k, v in value.items())
    if isinstance(value, (list, tuple)):
        return sum(_check_summary(name, v, key) for v in value)
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return 0
    if not math.isfinite(value):
        raise AssertionError(f"{name}: {key} = {value} is not finite")
    is_f1 = "f1" in key.lower() or key.startswith(("same:", "cross:", "pooled:",
                                                    "greedy", "student:"))
    if is_f1 and not 0.0 <= value <= 1.0:
        raise AssertionError(f"{name}: F1 {key} = {value} is not in [0, 1]")
    return int(is_f1)


def run_quality_scripts(features: str) -> int:
    """The eight quality scripts through their ``main`` at ``ModelConfig()``
    width on the training phase's folders, 1 epoch and the fewest seeds each
    takes: summaries finite, F1 in [0, 1], no extractor kernel launched.
    Returns the phase's threefry launches."""
    import importlib

    from mmer_tpu_torch.ops import prng

    folders = ["--video_feat_dir", os.path.join(features, "video"),
               "--audio_feat_dir", os.path.join(features, "audio")]
    t_phase = time.perf_counter()
    threefry0 = prng.launch_threefry.launches
    for name, argv in QUALITY_ARGS.items():
        script = importlib.import_module(f"mmer_tpu_torch.scripts.{name}")
        reset_launches()
        t0 = time.perf_counter()
        summary = script.main(argv + folders)
        wall = time.perf_counter() - t0
        n_f1 = _check_summary(name, summary)
        log(f"quality scripts: {name}: {wall:.2f} s wall, {n_f1} F1 values, "
            f"summary {json.dumps(summary)[:400]}")
        if not n_f1:
            raise AssertionError(f"{name}: no F1 in its summary")
        if any(read_launches().values()):
            raise AssertionError(f"{name} launched extractor kernels: "
                                 f"{read_launches()}")
    draws = prng.launch_threefry.launches - threefry0
    log(f"quality scripts: phase {time.perf_counter() - t_phase:.2f} s wall, "
        f"{draws} threefry launches")
    if not draws:
        raise AssertionError("the quality scripts drew no threefry launch")
    return draws


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

    t_run = time.perf_counter()
    host_reference()
    walls = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        log(f"phase {name}: {walls[name]:.2f} s wall, "
            f"{time.perf_counter() - t_run:.2f} s into the run")
        return out

    phase("2 build", build_kernels)
    kernels = phase("3 kernels", check_kernels, dev)
    kernels.update(phase("3 probe kernels", check_probe_kernels, dev))
    stream = phase("3a random stream", run_random_stream, dev)
    phase("3b JAX weights", run_jax_weights, dev)
    kernels.update(phase("3c positional conv", check_pos_conv, dev))
    kernels.update(phase("3d plain attention", check_plain_attention, dev))
    serving = phase("4 main path", run_main_path, dev)
    file_path = phase("4b serving file path", run_serving_file_path, dev)
    cold_start = phase("4c cold start", run_cold_start)
    extraction = phase("5 extraction", run_extraction, dev)
    profile = phase("6 profile scripts", run_profile_scripts)
    probes = phase("6b component probes", run_component_probes)
    int8 = phase("6c int8 path", run_int8_path, dev)
    # The training phase's feature folders, read again by the quality scripts
    # and the scale-out phase.
    features = tempfile.TemporaryDirectory(prefix="mmer_smoke_features_")
    try:
        request_launches, train_draws = phase("7 training", run_training, dev,
                                              features.name)
        phase("8 flagship chain", run_flagship_chain, dev, request_launches)
        quality_draws = phase("8b quality scripts", run_quality_scripts,
                              features.name)
        scale_out = phase("9 scale-out", run_scale_out, dev, extraction["chunks"],
                          extraction["waves"], features.name)
    finally:
        features.cleanup()
    prep_chain = phase("10 prep chain", run_prep_chain, dev)
    log(json.dumps({"phase_wall_s": walls,
                    "run_s": time.perf_counter() - t_run}))
    # launches: of the main path that runs the kernel.  The serving requests
    # for the three kernels on the clip path (which the serving file path and
    # the extraction CLI also run: launches_serving_file_path,
    # launches_extraction_cli), the all-kernel extraction run for the
    # varlen attention and the per-layer conv kernels, the profile and probe
    # scripts for the kernels only they launch.
    lines = [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1],
         "launches": (profile[name] if name in PROBE_KERNELS else
                      serving[name] or extraction["all_kernel"][name]),
         "launches_serving": serving[name],
         "launches_serving_file_path": file_path["launches"][name],
         "launches_extraction_cli": extraction["cli"][name],
         "launches_extraction_all_kernel": extraction["all_kernel"][name],
         "launches_profile_scripts": profile[name],
         "launches_component_probes": probes[name],
         "launches_scale_out": scale_out[name],
         "launches_prep_chain": prep_chain[name],
         "launches_cold_start_warmup": cold_start.get(name, 0),
         **{k: v for k, v in r.items() if not k.startswith("shape")}}
        for name, r in kernels.items()]
    # The int8 kernels: launches of phase 6c's probes (no other path reaches
    # them; every other phase's count of them is 0).
    lines += [
        {"name": name, "route": "cuda", "source": "mmer_tpu_torch/csrc/qdot.cu",
         "replaces": INT8_SOURCES[name], "launches": int8["launches"][name],
         "launches_serving": serving[name],
         "launches_serving_file_path": file_path["launches"][name],
         "launches_extraction_cli": extraction["cli"][name],
         "launches_extraction_all_kernel": extraction["all_kernel"][name],
         "launches_profile_scripts": profile[name],
         "launches_component_probes": probes[name],
         "launches_scale_out": scale_out[name],
         "launches_prep_chain": prep_chain[name],
         "launches_cold_start_warmup": cold_start.get(name, 0),
         **{k: v for k, v in r.items() if not k.startswith("shape")}}
        for name, r in int8["kernels"].items()]
    lines.append({"name": "threefry", "route": "cuda",
                  "source": "mmer_tpu_torch/csrc/threefry.cu",
                  "replaces": "mmer_tpu/train/loop.py:204 (jax.random's threefry "
                              "draws, which XLA compiles; not a Pallas kernel)",
                  "launches": train_draws,
                  "launches_training": train_draws + quality_draws,
                  "launches_component_probes": probes["threefry"],
                  "launches_cold_start_warmup": cold_start.get("threefry", 0),
                  **{k: v for k, v in stream.items()}})
    idle = [k["name"] for k in lines if k["launches"] < 1]
    if idle or len(lines) != len(SOURCES) + len(INT8_SOURCES) + 1:
        raise AssertionError(f"kernels never launched on a main path: {idle}")
    idle = [k for k in ("flash_attention", "fused_ffn", "fused_conv_encoder")
            if prep_chain[k] < 1]
    if idle:
        raise AssertionError(f"the prep chain never launched {idle}")
    routed = [k["name"] for k in lines if k["name"] in INT8_SOURCES
              and any(v for f, v in k.items() if f.startswith("launches_"))]
    if routed:
        raise AssertionError(f"a path other than the int8 probes launched {routed}")
    log(json.dumps({"int8_probes": int8["probes"], "int8_gemm_tops": int8["gemm_rates"]}))
    log(json.dumps({"kernels": lines}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _ulps(a, b):
    """float32 ulp distances of two arrays; opposite signs count as far."""
    import numpy as np

    ia = np.asarray(a, np.float32).ravel().view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).ravel().view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def _row_rel_l2(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)


def run_jax_weights(dev, fixture: str | None = None) -> None:
    """Phase 3b: the JAX package's weights and features on the card."""
    import numpy as np
    import torch

    from mmer_tpu_torch.config import ViViTConfig, Wav2Vec2Config
    from mmer_tpu_torch.models import jax_init
    from mmer_tpu_torch.models.convert import vivit_from_flax, wav2vec2_from_flax
    from mmer_tpu_torch.models.wav2vec2 import AudioEmbedder
    from mmer_tpu_torch.preprocess.extract import VideoFeatureExtractor

    t_phase = time.perf_counter()
    with np.load(fixture or jax_init.FIXTURE) as z:
        fx = {k: z[k] for k in z.files}
    meta = json.loads(str(fx["meta"]))
    log(f"JAX weights: fixture of jax {meta['jax']} / flax {meta['flax']}, "
        f"{meta['samples']} samples a leaf")
    vcfg, wcfg = ViViTConfig(), Wav2Vec2Config()

    # 1. Both full trees regenerated on the card, timed: every random leaf
    # one launch of the threefry kernel.
    from mmer_tpu_torch.ops import prng

    torch.cuda.synchronize()
    draws0 = prng.launch_threefry.launches
    t0 = time.perf_counter()
    trees = {"vivit": jax_init.vivit_tree(vcfg, device=dev),
             "wav2vec2": jax_init.wav2vec2_tree(wcfg, device=dev)}
    torch.cuda.synchronize()
    regen_s = time.perf_counter() - t0
    draws = prng.launch_threefry.launches - draws0
    want_draws = (random_leaves(jax_init.vivit_spec(vcfg))
                  + random_leaves(jax_init.wav2vec2_spec(wcfg)))
    n_params = sum(v.numel() for t in trees.values()
                   for v in jax_init.flat_leaves(t).values())
    log(f"JAX weights: ViViT {vcfg.dim}x{vcfg.depth} and Wav2Vec2 "
        f"{wcfg.hidden_dim}x{wcfg.num_layers} regenerated on the card in "
        f"{regen_s:.2f} s ({n_params} params; limit {REGEN_LIMIT_S} s), "
        f"{draws} threefry launches ({want_draws} random leaves)")
    if regen_s > REGEN_LIMIT_S:
        raise AssertionError("regenerating the extractors' weights took too long")
    if draws != want_draws:
        raise AssertionError("the regeneration did not draw each random leaf "
                             "in one threefry launch")

    # 2. Every leaf at the fixture's sampled indices.
    for name, tree in trees.items():
        leaves = jax_init.flat_leaves(tree["params"])
        if list(leaves) != [str(n) for n in fx[f"{name}_leaves"]]:
            raise AssertionError(f"{name}: the regenerated tree's leaves differ "
                                 "from the fixture's")
        got = torch.cat([
            v.reshape(-1)[torch.as_tensor(jax_init.sample_indices(
                v.numel(), meta["samples"]), device=dev)]
            for v in leaves.values()]).cpu().numpy()
        d = _ulps(got, fx[f"{name}_samples"])
        log(f"JAX weights: {name}: {len(leaves)} leaves, {d.size} sampled "
            f"values, {float((d == 0).mean()) * 100:.4f} % bit-equal, worst "
            f"{int(d.max())} ulp (limit {JAX_MAX_ULP})")
        if d.max() > JAX_MAX_ULP:
            raise AssertionError(f"{name}: regenerated weights differ from "
                                 "JAX's")

    # 3. The default extractors hold those weights; the inputs are the
    # fixture's.
    chunks, waves = jax_init.reference_inputs(meta["input_seed"])
    if jax_init.inputs_digest(chunks, waves) != str(fx["inputs_sha1"]):
        raise AssertionError("the seeded inputs differ from the fixture's")
    t0 = time.perf_counter()
    video = VideoFeatureExtractor(vcfg, device=dev)
    audio = AudioEmbedder(wcfg, device=dev)
    torch.cuda.synchronize()
    log(f"JAX weights: default extractors built in "
        f"{time.perf_counter() - t0:.2f} s")
    for model, want in ((video.model, vivit_from_flax(trees["vivit"])),
                        (audio.model, wav2vec2_from_flax(trees["wav2vec2"]))):
        got = model.state_dict()
        if set(got) != set(want) or not all(torch.equal(got[k], want[k])
                                            for k in want):
            raise AssertionError("a default extractor's weights are not the "
                                 "regenerated tree's")
    del trees, want, got
    vstate, astate = video.model.state_dict(), audio.model.state_dict()
    f32 = dataclasses.replace
    n_k3 = sum(k == 3 for k in wcfg.conv_kernels[1:])
    zero = {k: 0 for k in read_launches()}
    routes = {
        "video f32 plain": (VideoFeatureExtractor(
            f32(vcfg, compute_dtype="float32"), device=dev, use_kernels=False,
            params=vstate), zero),
        "video kernel route": (video, {**zero, "flash_attention": vcfg.depth,
                                       "fused_ffn": vcfg.depth}),
        "audio f32 plain": (AudioEmbedder(
            f32(wcfg, compute_dtype="float32"), device=dev, use_kernels=False,
            params=astate), zero),
        "audio default route": (audio, {
            **zero, "fused_conv_encoder": len(wcfg.conv_dims),
            "fused_ffn": wcfg.num_layers, "pos_conv": 1,
            "plain_attention": wcfg.num_layers}),
        "audio all-kernel route": (AudioEmbedder(
            wcfg, device=dev, params=astate, use_flash_attn=True, mega=False), {
            **zero, "flash_attention_varlen": wcfg.num_layers,
            "fused_ffn": wcfg.num_layers, "pos_conv": 1,
            "conv_gemm_ln_gelu": len(wcfg.conv_dims) - n_k3,
            "conv_k3_ln_gelu": n_k3}),
        "audio bf16 plain": (AudioEmbedder(
            wcfg, device=dev, use_kernels=False, params=astate), zero),
        "video bf16 plain": (VideoFeatureExtractor(
            vcfg, device=dev, use_kernels=False, params=vstate), zero),
    }
    feats = {}
    for label, (ext, want) in routes.items():
        reset_launches()
        t0 = time.perf_counter()
        out = (ext.embed_chunks(chunks) if label.startswith("video")
               else ext.embed_batch(waves))
        torch.cuda.synchronize()
        got = read_launches()
        log(f"JAX weights: {label}: {(time.perf_counter() - t0) * 1e3:.1f} ms, "
            f"launches {got}")
        if got != want:
            raise AssertionError(f"{label}: launch counts {got}, expected {want}")
        if not np.isfinite(out).all() or out.shape != fx[
                "video_float32" if label.startswith("video") else
                "audio_float32"].shape:
            raise AssertionError(f"{label}: features {out.shape} not finite or "
                                 "of the fixture's shape")
        feats[label] = out

    # 4. The gates.
    def rows(a, b) -> str:
        return np.array2string(_row_rel_l2(a, b), precision=4)

    # JAX's bf16 audio features come from its Pallas route (the one the
    # port's kernels mirror) and, apart, from its XLA route.
    log(f"JAX weights: JAX's own features, rel-L2 a row: video bf16 vs f32 "
        f"{rows(fx['video_bfloat16'], fx['video_float32'])}; audio bf16 vs "
        f"f32 {rows(fx['audio_bfloat16'], fx['audio_float32'])}, its XLA "
        f"route's bf16 vs f32 {rows(fx['audio_bfloat16_xla'], fx['audio_float32'])}"
        f", bf16 Pallas vs XLA route "
        f"{rows(fx['audio_bfloat16'], fx['audio_bfloat16_xla'])}")
    # Every distance is logged before any gate is applied.
    for label, out in feats.items():
        kind = label.split()[0]
        xla = (f", bf16 XLA route {rows(out, fx['audio_bfloat16_xla'])}"
               if kind == "audio" else "")
        log(f"JAX weights: {label} vs JAX's features, rel-L2 a row: f32 "
            f"{rows(out, fx[f'{kind}_float32'])}, bf16 "
            f"{rows(out, fx[f'{kind}_bfloat16'])}{xla}")
    failed = []
    for label, ref, limit in (
            ("video f32 plain", "video_float32", JAX_F32_REL_L2),
            ("audio f32 plain", "audio_float32", JAX_F32_REL_L2),
            ("audio default route", "audio_bfloat16", EMBED_REL_L2),
            ("audio all-kernel route", "audio_bfloat16", EMBED_REL_L2)):
        if not np.all(_row_rel_l2(feats[label], fx[ref]) <= limit):
            failed.append(f"{label} vs JAX's {ref} (limit {limit} a row)")
    # Video over both chunks: the bf16 floor varies from row to row.
    rel = _rel_l2(feats["video kernel route"], fx["video_float32"])
    floor = _rel_l2(fx["video_bfloat16"], fx["video_float32"])
    log(f"JAX weights: video kernel route vs JAX's f32 features over both "
        f"chunks {rel:.4e}; JAX's bf16 vs f32 {floor:.4e}; ratio "
        f"{rel / floor:.3f} (limit {JAX_VIDEO_BF16_FACTOR})")
    if rel > JAX_VIDEO_BF16_FACTOR * floor:
        failed.append("video kernel route vs JAX's f32 features")
    if failed:
        raise AssertionError("features beyond their limits from the JAX "
                             f"package's: {failed}")
    phase_s = time.perf_counter() - t_phase
    log(f"JAX weights: phase {phase_s:.2f} s wall (limit {JAX_PHASE_LIMIT_S} s)")
    if phase_s > JAX_PHASE_LIMIT_S:
        raise AssertionError("the JAX-weights phase took too long")


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
    from mmer_tpu_torch.preprocess.extract import VideoFeatureExtractor
    from mmer_tpu_torch.serve.engine import InferenceEngine

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

    from mmer_tpu_torch.ops.fused_blocks import fused_ffn

    serve(engine, "first")
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    kernel_probs = serve(engine, "warm")
    launches = read_launches()
    reduce_passes = fused_ffn.reduce_launches
    log(f"peak device memory (warm pass): "
        f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")

    bs = engine.video_extractor.device_batch
    vivit_batches = sum(-(-len(args[0]) // bs) for _, _, args in requests)
    w2v2_forwards = len(requests)
    # Serving keeps Wav2Vec2 attention plain and the conv encoder on its
    # whole-pyramid route, as the JAX AudioEmbedder does; the profile and
    # probe kernels are on no request's path.
    expected = {
        **{k: 0 for k in launches},
        "flash_attention": vivit_batches * vcfg.depth,
        "fused_ffn": vivit_batches * vcfg.depth + w2v2_forwards * wcfg.num_layers,
        "fused_conv_encoder": w2v2_forwards * len(wcfg.conv_dims),
        "pos_conv": w2v2_forwards,
        "plain_attention": w2v2_forwards * wcfg.num_layers,
    }
    log(f"launch counts {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError("the main path did not launch the kernels as "
                             "expected")
    # A ViViT batch fills the card with one slice of the hidden dimension; no
    # Wav2Vec2 forward of a request does, so each of its FFN calls takes the
    # split plan and its reduce pass.
    expected_reduce = w2v2_forwards * wcfg.num_layers
    log(f"fused_ffn reduce passes in the warm pass: {reduce_passes}, "
        f"expected {expected_reduce}")
    if reduce_passes != expected_reduce:
        raise AssertionError("fused_ffn did not take the grid plans expected")

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


# -- phase 4b: the serving file path -------------------------------------------
#
# Copies of the FLV builders of tests/test_remux.py (the script imports no
# test module: those import the JAX package).

class _BitWriter:
    def __init__(self):
        self.bits = []

    def u(self, value: int, bits: int):
        for i in reversed(range(bits)):
            self.bits.append((value >> i) & 1)

    def ue(self, value: int):
        code = value + 1
        n = code.bit_length()
        self.u(0, n - 1)
        self.u(code, n)

    def bytes(self) -> bytes:
        bits = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(int("".join(map(str, bits[i:i + 8])), 2)
                     for i in range(0, len(bits), 8))


def _make_sps(width_mbs: int = 40, height_mbs: int = 30) -> bytes:
    """Baseline-profile SPS for (width_mbs*16) x (height_mbs*16) pixels."""
    w = _BitWriter()
    for value, bits in ((0x67, 8), (66, 8), (0, 8), (30, 8)):
        w.u(value, bits)               # NAL type 7, baseline, level 3.0
    for value in (0, 0, 0, 0, 1):      # sps id, frame num, poc type, lsb, refs
        w.ue(value)
    w.u(0, 1)
    w.ue(width_mbs - 1)
    w.ue(height_mbs - 1)
    for flag in (1, 0, 0, 0, 1):       # frame_mbs_only ... rbsp stop bit
        w.u(flag, 1)
    return w.bytes()


def _flv_tag(tag_type: int, ts: int, body: bytes) -> bytes:
    import struct

    return (bytes([tag_type]) + len(body).to_bytes(3, "big")
            + (ts & 0xFFFFFF).to_bytes(3, "big") + bytes([ts >> 24])
            + b"\x00\x00\x00" + body + struct.pack(">I", 11 + len(body)))


def _make_flv(n_video: int = 96, n_audio: int = 50) -> bytes:
    """A synthetic H.264 + AAC FLV at 30 fps (real SPS and
    AudioSpecificConfig, opaque sample payloads, as tests/test_remux.py
    builds it)."""
    import struct

    sps, pps = _make_sps(), b"\x68\xce\x38\x80"
    avcc = (bytes([1, sps[1], sps[2], sps[3], 0xFF, 0xE1])
            + struct.pack(">H", len(sps)) + sps
            + bytes([1]) + struct.pack(">H", len(pps)) + pps)

    def video(ts, payload, key, pkt=1):
        head = bytes([((1 if key else 2) << 4) | 7, pkt]) + b"\x00\x00\x00"
        return _flv_tag(9, ts, head + payload)

    def audio(ts, payload, pkt=1):
        return _flv_tag(8, ts, bytes([0xAF, pkt]) + payload)

    out = bytearray(b"FLV\x01\x05" + struct.pack(">I", 9) + b"\x00" * 4)
    out += video(0, avcc, True, pkt=0)
    out += audio(0, bytes([0x14, 0x08]), pkt=0)      # AAC-LC, 16 kHz, mono
    for i in range(n_video):
        key = i % 30 == 0
        body = bytes([0x65 if key else 0x41]) + b"frame-%04d" % i
        out += video(i * 1000 // 30, struct.pack(">I", len(body)) + body, key)
    for i in range(n_audio):
        out += audio(i * 64, b"aac-frame-%d" % i)  # 1024 samples at 16 kHz
    return bytes(out)


def _iou(a, b) -> float:
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / union if union > 0 else 0.0


def _face_frames(n: int, absent, rng):
    """``n`` 480x640 RGB frames: the packaged face (300x256, seeded ±8
    jitter a frame) pasted at FACE_AT on a smooth background, except the
    frames in ``absent``, which hold the background alone."""
    import numpy as np

    face = np.load(os.path.join(REPO, "mmer_tpu_torch", "assets",
                                "face_300x256.npy"))
    yy, xx = np.mgrid[0:480, 0:640]
    background = np.stack([70 + yy * 0.15, 90 + xx * 0.1, 110 + yy * 0.05],
                          -1).astype(np.uint8)
    y0, x0 = FACE_AT
    for i in range(n):
        frame = background.copy()
        if i not in absent:
            jitter = face.astype(np.int16) + rng.integers(-8, 8, face.shape)
            frame[y0:y0 + 300, x0:x0 + 256] = np.clip(jitter, 0, 255)
        yield frame


def _serve_http(engine, flv: bytes) -> bytes:
    """The port's server on 127.0.0.1 in a thread: /ping, /health,
    /remux/ (returns the MP4), /infer/ without a file, an oversized upload."""
    import http.client
    import threading
    from http.server import ThreadingHTTPServer

    from mmer_tpu_torch.serve.app import make_handler
    from mmer_tpu_torch.serve.remux import flv_to_mp4

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]

    def request(method, path, body=b"", headers=None, send_body=True):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            if send_body:
                conn.request(method, path, body=body, headers=headers or {})
            else:                      # headers only: the server must not wait
                conn.putrequest(method, path)
                for k, v in (headers or {}).items():
                    conn.putheader(k, v)
                conn.endheaders()
            r = conn.getresponse()
            return r.status, r.getheader("Content-Type"), r.read()
        finally:
            conn.close()

    boundary = "smokebound"
    multipart = {"Content-Type": f"multipart/form-data; boundary={boundary}"}
    upload = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
              f"filename=\"clip.flv\"\r\n\r\n").encode() + flv \
        + f"\r\n--{boundary}--\r\n".encode()
    try:
        got = {
            "/ping": request("GET", "/ping"),
            "/health": request("GET", "/health"),
            "/remux/": request("POST", "/remux/", upload, multipart),
            "/infer/ without a file": request(
                "POST", "/infer/", f"--{boundary}--".encode(), multipart),
            "/infer/ 4 GiB Content-Length": request(
                "POST", "/infer/", headers={**multipart,
                                           "Content-Length": str(4 << 30)},
                send_body=False),
        }
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    want = {"/ping": (200, b'{"message": "pong"}'),
            "/health": (200, b'{"status": "ok"}'),
            "/remux/": (200, flv_to_mp4(flv)),
            "/infer/ without a file": (422, None),
            "/infer/ 4 GiB Content-Length": (413, None)}
    for route, (status, ctype, body) in got.items():
        log(f"serving http {route}: {status} {ctype} ({len(body)} bytes)")
        code, payload = want[route]
        if status != code or (payload is not None and body != payload):
            raise AssertionError(f"{route}: {status} {body[:200]!r}")
    if got["/remux/"][1] != "video/mp4":
        raise AssertionError("/remux/ did not answer video/mp4")
    return got["/remux/"][2]


def _ig_check(engine, records, dev) -> dict:
    """IG of every explained window batch: finite attributions, and the
    completeness residual sum(attr) - (logit_t(x) - logit_t(0)) of the
    card's bf16 run against the same residual of an f32 run on the CPU
    (same weights, inputs and targets), within IG_RESIDUAL_TOL."""
    import dataclasses as dc

    import numpy as np
    import torch

    from mmer_tpu_torch.interpret.ig import integrated_gradients
    from mmer_tpu_torch.models.fusion import MultimodalEmotionModel

    f32 = MultimodalEmotionModel(dc.replace(engine.model_cfg,
                                            compute_dtype="float32"),
                                 device="cpu")
    f32.load_state_dict({k: v.cpu() for k, v in
                         engine.fusion.state_dict().items()})

    def residual(fn, v, a, m, t, av, aa):
        with torch.no_grad():
            lx, l0 = fn(v, a, m), fn(torch.zeros_like(v), torch.zeros_like(a), m)
        gap = (lx - l0).float().gather(1, t[:, None].long())[:, 0]
        total = av.sum(dim=(1, 2)) + aa.sum(dim=1)
        return (total - gap).double().cpu().numpy(), gap.double().cpu().numpy()

    worst, rows, rel = 0.0, 0, []
    for (v, a, m, t), (av, aa) in records:
        if not (torch.isfinite(av).all() and torch.isfinite(aa).all()):
            raise AssertionError("IG attributions are not finite")
        r_card, gap = residual(engine.fusion_logits_fn, v, a, m, t, av, aa)
        cpu = [x.cpu() for x in (v, a, m, t)]

        def fn32(v_, a_, m_):
            return f32(v_, a_, m_)[1]

        av32, aa32 = integrated_gradients(fn32, *cpu, 50, "gausslegendre")
        r_f32, _ = residual(fn32, *cpu, av32, aa32)
        worst = max(worst, float(np.abs(r_card - r_f32).max()))
        rows += len(gap)
        rel.append(_rel_l2(torch.cat([av.flatten(1), aa], 1).double().cpu().numpy(),
                           torch.cat([av32.flatten(1), aa32], 1).double().numpy()))
        log(f"  IG batch {tuple(v.shape)}: logit gaps {np.round(gap, 4).tolist()}, "
            f"completeness residual card {np.round(r_card, 4).tolist()} vs f32 "
            f"CPU {np.round(r_f32, 4).tolist()}")
    log(f"serving IG: {rows} windows, largest |residual card - residual f32| "
        f"{worst:.4f} (limit {IG_RESIDUAL_TOL}); attributions card vs f32 "
        f"rel-L2 up to {max(rel):.4f}")
    if not rows or worst > IG_RESIDUAL_TOL:
        raise AssertionError("IG on the card departs from the f32 quadrature")
    return {"windows": rows, "residual_gap": worst, "rel_l2": max(rel)}


def run_serving_file_path(dev) -> dict:
    """The /infer path at full width: face detection (native cascade),
    on-device crops, streamed subchunks, ViViT, Wav2Vec2 on the audio of a
    container built with the port's own remux and PCM mux, fusion and IG,
    through ``InferenceEngine.infer_frames``; then the HTTP server.
    Returns the launch counts of the warm requests, summed."""
    import tempfile

    import numpy as np
    import torch

    from mmer_tpu_torch.interpret import ig
    from mmer_tpu_torch.preprocess.audio import extract_audio_track
    from mmer_tpu_torch.preprocess.faces import HaarFaceDetector
    from mmer_tpu_torch.serve.engine import InferenceEngine
    from mmer_tpu_torch.serve.pcm_mp4 import mux_pcm_track

    detector = HaarFaceDetector()
    t0 = time.perf_counter()
    if detector.engine != "native":
        raise AssertionError("the face detector runs its numpy fallback: the "
                             "native cascade evaluator did not build")
    log(f"serving file path: cascade engine {detector.engine} "
        f"(built in {time.perf_counter() - t0:.2f} s)")
    engine = InferenceEngine(dev, detector=detector)
    _ = engine.video_extractor, engine.audio_embedder, engine.fusion

    # Audio through the port's container code: FLV -> /remux/ -> MP4 -> PCM
    # track muxed in -> written -> extract_audio_track.
    flv = _make_flv()
    mp4 = _serve_http(engine, flv)
    rng = np.random.default_rng(7)
    waves = {}
    with tempfile.TemporaryDirectory(prefix="mmer_smoke_serve_") as tmp:
        for name, seconds in (("A", 3.2), ("B", 160 / 30)):
            wave = (rng.normal(size=int(seconds * 16000)) * 0.1
                    ).astype(np.float32)
            path = os.path.join(tmp, f"{name}.mp4")
            with open(path, "wb") as f:
                f.write(mux_pcm_track(mp4, wave, 16000))
            waves[name] = extract_audio_track(path, 16000)
            err = float(np.abs(waves[name] - wave).max())
            log(f"serving audio {name}: {len(waves[name])} samples back from "
                f"{os.path.getsize(path)} bytes of MP4, max |error| {err:.2e}")
            if len(waves[name]) != len(wave) or err > 1.0 / 32768:
                raise AssertionError("the PCM track did not come back")

    requests = {
        "A": dict(n=96, absent=(), explain=False, wave=waves["A"]),
        "B": dict(n=160, absent=range(64, 80), explain=True, wave=waves["B"]),
        "B_plain": dict(n=160, absent=range(64, 80), explain=False,
                        wave=waves["B"]),
        "C": dict(n=32, absent=range(32), explain=False, wave=waves["A"]),
    }
    fy, fx = FACE_AT
    face_rect = (FACE_RECT[0] + fx, FACE_RECT[1] + fy,
                 FACE_RECT[2] + fx, FACE_RECT[3] + fy)
    records = []
    real_ig = ig.integrated_gradients

    def recording_ig(fn, v, a, m, t, *args):
        out = real_ig(fn, v, a, m, t, *args)
        records.append(((v, a, m, t), tuple(x.detach() for x in out)))
        return out

    vcfg, wcfg = engine.vivit_cfg, engine.wav_cfg
    bs = engine.video_extractor.device_batch
    results, total, summary = {}, {}, {}
    ig.integrated_gradients = recording_ig
    try:
        for name, req in requests.items():
            for label in ("first", "warm"):
                frames = _face_frames(req["n"], set(req["absent"]),
                                      np.random.default_rng(11))
                records.clear()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                reset_launches()
                t0 = time.perf_counter()
                res = engine.infer_frames(frames, 30.0, req["wave"], 32, 5,
                                          explain=req["explain"],
                                          detect_every=1)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                launches = read_launches()
            tm = engine.last_timings
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
            log(f"serving request {name} [warm]: {ms:.2f} ms for {tm['frames']} "
                f"frames: detection {tm['detect'] * 1e3 / tm['frames']:.3f} ms a "
                f"frame ({tm['detect'] * 1e3:.2f} ms), crop + ViViT "
                f"{tm['crop_vivit'] * 1e3:.2f} ms, audio {tm['audio'] * 1e3:.2f} "
                f"ms, fusion {tm['fusion'] * 1e3:.2f} ms, IG "
                f"{tm['ig'] * 1e3:.2f} ms; peak device memory {peak:.1f} MiB")
            results[name] = (res, launches, records[:])
            summary[name] = {"warm_ms": ms, "frames": tm["frames"],
                             "detect_ms_a_frame": tm["detect"] * 1e3 / tm["frames"],
                             **{f"{k}_ms": tm[k] * 1e3 for k in
                                ("detect", "crop_vivit", "audio", "fusion", "ig")},
                             "peak_mib": peak}
            for k, n in launches.items():
                total[k] = total.get(k, 0) + n
    finally:
        ig.integrated_gradients = real_ig
    log(f"serving file path, warm, on {device_line()}: {json.dumps(summary)}")

    for name, req in requests.items():
        res, launches, recs = results[name]
        absent = set(req["absent"])
        face_frames = [i for i in range(req["n"]) if i not in absent]
        boxed = {b["frame"] for b in res["bounding_box"]}
        hit = len(boxed & set(face_frames)) / max(len(face_frames), 1)
        best = {}
        for b in res["bounding_box"]:
            if b["frame"] not in best or b["confidence"] > best[b["frame"]]["confidence"]:
                best[b["frame"]] = b
        ious = [_iou((b["x1"], b["y1"], b["x2"], b["y2"]), face_rect)
                for b in best.values()]
        # Sequences: runs of face frames split by gaps of more than 10.
        seqs, prev = [], None
        for i in face_frames:
            if prev is None or i - prev > 10:
                seqs.append([])
            seqs[-1].append(i)
            prev = i
        n_subs = [-(-len(s) // 32) for s in seqs]
        frames_want = [s[j * 32] for s, k in zip(seqs, n_subs) for j in range(k)]
        vivit_batches = sum(-(-k // bs) for k in n_subs)
        expected = {**{k: 0 for k in launches},
                    "flash_attention": vivit_batches * vcfg.depth,
                    "fused_ffn": vivit_batches * vcfg.depth
                    + len(seqs) * wcfg.num_layers,
                    "fused_conv_encoder": len(seqs) * len(wcfg.conv_dims),
                    "pos_conv": len(seqs),
                    "plain_attention": len(seqs) * wcfg.num_layers}
        probs = np.asarray(res["probabilities"], np.float64).reshape(-1, 6)
        log(f"serving request {name}: boxes on {hit * 100:.1f} % of "
            f"{len(face_frames)} face frames, on {len(boxed & absent)} of "
            f"{len(absent)} others; best-box IoU with the face "
            f"{min(ious) if ious else float('nan'):.3f}-"
            f"{max(ious) if ious else float('nan'):.3f}; "
            f"{len(seqs)} sequences, items at frames "
            f"{[it['frame'] for it in res['inference']]} classes "
            f"{[it['class'] for it in res['inference']]}")
        shown = [k for k in launches if launches[k] or expected[k]]
        log(f"serving request {name}: launch counts "
            f"{ {k: launches[k] for k in shown} }, expected "
            f"{ {k: expected[k] for k in shown} } (all others 0)")
        if (face_frames and hit < 0.9) or boxed & absent or \
                (ious and min(ious) < 0.5):
            raise AssertionError(f"request {name}: the detector missed or "
                                 "misplaced the face")
        if [it["frame"] for it in res["inference"]] != frames_want:
            raise AssertionError(f"request {name}: items at the wrong frames")
        if not (np.isfinite(probs).all()
                and np.allclose(probs.sum(-1), 1.0, atol=1e-4)):
            raise AssertionError(f"request {name}: probabilities {probs}")
        if launches != expected:
            raise AssertionError(f"request {name}: kernel launches off")
        if req["explain"] and not all("feature_importance" in it
                                      for it in res["inference"]):
            raise AssertionError(f"request {name}: importances missing")
    if [len(results["B"][0]["inference"]), len(results["C"][0]["bounding_box"]),
            len(results["C"][0]["inference"])] != [5, 0, 0]:
        raise AssertionError("requests B and C did not give 2 + 3 and no items")
    strip = [{k: v for k, v in it.items() if k != "feature_importance"}
             for it in results["B"][0]["inference"]]
    if strip != results["B_plain"][0]["inference"]:
        raise AssertionError("explain=True changed request B's classes")
    return {"launches": total, "ig": _ig_check(engine, results["B"][2], dev)}


# -- phase 4c: the serving cold start -------------------------------------------

COLD_START_LIMIT_S = 120.0
# The warmed first request (explain=true) within this many warm explain p50s.
COLD_FIRST_FACTOR = 1.5
COLD_REQUESTS = 4


def _run_script(args: list, timeout: float) -> tuple:
    """``python3 -m args`` in a fresh process from the repository root →
    (the last stdout line as JSON, the stdout lines, the stderr lines).
    Raises when it exits non-zero; killed at ``timeout``."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout,
                          check=False)
    log(f"cold start: {' '.join(args)}: exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.2f} s")
    if proc.returncode != 0:
        log(proc.stdout[-3000:])
        log(proc.stderr[-6000:])
        raise AssertionError(f"{args[0]} exited {proc.returncode}")
    out = proc.stdout.strip().splitlines()
    return json.loads(out[-1]), out, proc.stderr.splitlines()


def _cold_line(err: list) -> dict:
    prefix = "cold start: "
    return json.loads(next(l for l in err if l.startswith(prefix))[len(prefix):])


def run_cold_start() -> dict:
    """Phase 4c: the serving cold start in fresh processes.  Returns the
    warmup's launches (run b's)."""
    t_phase = time.perf_counter()
    serving = ["mmer_tpu_torch.scripts.bench_serving", "--route", "frames",
               "--requests", str(COLD_REQUESTS)]
    cold, _, cold_err = _run_script(serving + ["--no_warmup"],
                                    COLD_START_LIMIT_S)
    warm, _, warm_err = _run_script(
        serving + ["--warmup_resolutions", "256x300", "--warmup_upload"],
        COLD_START_LIMIT_S)
    extract, extract_out, _ = _run_script(["mmer_tpu_torch.scripts.bench_extract"],
                                          COLD_START_LIMIT_S)
    a, b = _cold_line(cold_err), _cold_line(warm_err)
    for tag, res, info in (("a, no warmup", cold, a), ("b, warmed", warm, b)):
        log(f"cold start ({tag}): first request (explain=true) "
            f"{res['first_request_s']} s; explain=false p50 {res['p50_ms']} / "
            f"p95 {res['p95_ms']} ms, explain=true p50 {res['explain_p50_ms']} "
            f"/ p95 {res['explain_p95_ms']} ms; novel resolution 280x310 "
            f"{res['same_bucket_novel_res_s']} s, new bucket 500x700 "
            f"{res['new_bucket_first_req_s']} s; kernel libraries built "
            f"{info['kernel_builds_in_warmup']} in warmup, "
            f"{info['kernel_builds_after_warmup']} after")
    warmup = b["warmup"]
    log(f"cold start (b): warmup {warmup['seconds']:.2f} s: "
        + "; ".join(f"{name} {sec:.3f} s" for name, sec in warmup["phases"]))
    log(f"cold start (b): warmup launches {warmup['launches']}")
    for line in extract_out[1:5]:
        log(f"cold start (c): bench_extract {line}")
    log(f"cold start (c): {json.dumps(extract)}")
    if b["kernel_builds_after_warmup"]:
        raise AssertionError("a kernel library was built after the warmup")
    idle = [k for k in ("flash_attention", "fused_ffn", "fused_conv_encoder")
            if warmup["launches"].get(k, 0) < 1]
    if idle:
        raise AssertionError(f"the warmup never launched {idle}")
    first_ms = warm["first_request_s"] * 1e3
    log(f"cold start: warmed first request {first_ms:.0f} ms = "
        f"{first_ms / warm['explain_p50_ms']:.3f} x the warm explain p50 "
        f"(limit {COLD_FIRST_FACTOR}); cold first request "
        f"{cold['first_request_s'] * 1e3:.0f} ms = "
        f"{cold['first_request_s'] * 1e3 / cold['explain_p50_ms']:.3f} x its p50")
    if first_ms > COLD_FIRST_FACTOR * warm["explain_p50_ms"]:
        raise AssertionError("the warmed first request is not at steady-state "
                             "latency")
    phase_s = time.perf_counter() - t_phase
    log(f"cold start: phase {phase_s:.2f} s wall (limit {COLD_START_LIMIT_S} s)")
    if phase_s > COLD_START_LIMIT_S:
        raise AssertionError("the cold-start phase took too long")
    return warmup["launches"]


def host_reference() -> dict:
    """A fixed host workload, seconds each: a single-threaded Python loop,
    copying 256 MiB with numpy, and the native cascade on the packaged face
    (20 calls)."""
    import numpy as np

    from mmer_tpu_torch.preprocess.faces import HaarFaceDetector

    out = {}
    t0 = time.perf_counter()
    total = 0
    for i in range(3_000_000):
        total += i
    out["python_loop_s"] = time.perf_counter() - t0
    buf = np.ones(2 ** 25)
    t0 = time.perf_counter()
    for _ in range(4):
        buf.copy()
    out["numpy_copy_s"] = time.perf_counter() - t0
    face = np.load(os.path.join(REPO, "mmer_tpu_torch", "assets",
                                "face_300x256.npy"))
    det = HaarFaceDetector()
    det.detect(face)
    t0 = time.perf_counter()
    for _ in range(20):
        det.detect(face)
    out["cascade_s"] = time.perf_counter() - t0
    log(f"host reference: {json.dumps(out)} (os.cpu_count {os.cpu_count()})")
    return out


def _write_wav(path: str, wave, rate: int, channels: int = 1) -> None:
    import wave as wave_mod

    import numpy as np

    pcm = np.clip(wave * 32768.0, -32768, 32767).astype(np.int16)
    with wave_mod.open(path, "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(2)
        f.setframerate(rate)
        f.writeframes(pcm.tobytes())


def _make_audio_folder(folder: str, rng) -> dict:
    """96 WAV files from a seed: 16 kHz int16 mono clips of 1.5-5.0 s under
    RAVDESS- and CREMA-D-style names, plus (sorting last, so that the first
    device batch holds 64 plain clips) one 12 s clip that the embedder splits
    at 10 s, one 44.1 kHz stereo file that goes through ``resample``, and one
    10 ms clip, shorter than the conv stack's 400-sample receptive field,
    which must embed to zero.  Returns file name → kind."""
    files = {}
    for i in range(93):
        seconds = float(rng.uniform(1.5, 5.0))
        wave = rng.normal(size=(int(seconds * 16000),)) * 0.1
        name = (f"03-01-{i % 8 + 1:02d}-01-02-01-{i % 24 + 1:02d}-{i:03d}.wav"
                if i % 2 else f"1{i:03d}_DFA_ANG_XX.wav")
        _write_wav(os.path.join(folder, name), wave, 16000)
        files[name] = "clip"
    _write_wav(os.path.join(folder, "9001_long_12s.wav"),
               rng.normal(size=(12 * 16000,)) * 0.1, 16000)
    files["9001_long_12s.wav"] = "long"
    _write_wav(os.path.join(folder, "9002_stereo_44k.wav"),
               rng.normal(size=(3 * 44100, 2)) * 0.1, 44100, channels=2)
    files["9002_stereo_44k.wav"] = "stereo"
    _write_wav(os.path.join(folder, "9003_10ms.wav"),
               rng.normal(size=(160,)) * 0.1, 16000)
    files["9003_10ms.wav"] = "short"
    return files


def run_extraction(dev) -> dict:
    """The offline extraction path at full width; returns the launch counts
    of the CLI run and of the all-kernel run."""
    import tempfile

    import numpy as np
    import torch

    from mmer_tpu_torch.config import ViViTConfig, Wav2Vec2Config
    from mmer_tpu_torch.models.wav2vec2 import AudioEmbedder
    from mmer_tpu_torch.preprocess import extract
    from mmer_tpu_torch.preprocess.audio import (audio_output_name,
                                                 iter_audio_files, load_waveform)

    vcfg, wcfg = ViViTConfig(), Wav2Vec2Config()
    rng = np.random.default_rng(1)
    with tempfile.TemporaryDirectory(prefix="mmer_smoke_") as tmp:
        in_dir, out_dir = os.path.join(tmp, "wav"), os.path.join(tmp, "npy")
        os.makedirs(in_dir)
        files = _make_audio_folder(in_dir, rng)

        # 1. The CLI, as a user runs it (on the card by default).
        reset_launches()
        t0 = time.perf_counter()
        extract.main(["audio", "--input", in_dir, "--output", out_dir,
                      "--batch_size", "64"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        cli_launches = read_launches()
        forwards = -(-len(files) // 64)      # one Wav2Vec2 forward per batch
        expected = {k: 0 for k in cli_launches}
        expected.update(fused_ffn=forwards * wcfg.num_layers,
                        fused_conv_encoder=forwards * len(wcfg.conv_dims),
                        pos_conv=forwards,
                        plain_attention=forwards * wcfg.num_layers)
        log(f"extraction CLI: {len(files)} files in {cli_s:.2f} s (model set-up "
            f"included); launch counts {cli_launches}, expected {expected}")
        if cli_launches != expected:
            raise AssertionError("the extraction CLI did not launch the kernels "
                                 "as expected")
        written = sorted(os.listdir(out_dir))
        if written != sorted(audio_output_name(n) for n in files):
            raise AssertionError(f"extraction CLI wrote {len(written)} files "
                                 "under unexpected names")
        cli = {}
        for name, kind in files.items():
            emb = np.load(os.path.join(out_dir, audio_output_name(name)))
            norm = float(np.linalg.norm(emb.astype(np.float32)))
            want = 0.0 if kind == "short" else 1.0
            if emb.dtype != np.float16 or emb.shape != (1024,) \
                    or not np.isfinite(emb).all() or abs(norm - want) > 2e-3:
                raise AssertionError(f"{name}: artifact {emb.dtype} {emb.shape} "
                                     f"norm {norm}")
            cli[name] = emb.astype(np.float32)
        log(f"extraction CLI: {len(written)} float16 (1024,) artifacts, unit "
            "norm, zero for the 10 ms clip")

        # 2. The same folder through iter_audio_embeddings on three encoders
        # that share one set of weights.
        default = AudioEmbedder(wcfg, device=dev)
        state = default.model.state_dict()
        all_kernel = AudioEmbedder(wcfg, device=dev, params=state,
                                   use_flash_attn=True, mega=False)
        plain = AudioEmbedder(wcfg, device=dev, use_kernels=False, params=state)
        seen = set()                    # waveform batches of the forwards
        for embedder in (default, all_kernel, plain):
            embedder.model.register_forward_pre_hook(
                lambda _, args: seen.add(tuple(args[0].shape)))
        routes = {"default (conv mega + FFN kernels, plain attention)": default,
                  "all-kernel (varlen attention, per-layer conv, FFN)": all_kernel,
                  "plain": plain}

        def embed_folder(embedder):
            t = time.perf_counter()
            out = dict(extract.iter_audio_embeddings(in_dir, embedder, 64,
                                                     verbose=False))
            torch.cuda.synchronize()
            return out, time.perf_counter() - t

        embs, rates, counts = {}, {k: [] for k in routes}, {}
        for label, embedder in routes.items():       # warm-up, and the counts
            reset_launches()
            embs[label], _ = embed_folder(embedder)
            counts[label] = read_launches()
        order = list(routes) + list(routes)[::-1]    # a b c c b a
        for label in order:
            _, seconds = embed_folder(routes[label])
            rates[label].append(len(files) / seconds)
        for label in routes:
            log(f"extraction, {label}: {rates[label][0]:.1f} and "
                f"{rates[label][1]:.1f} clips/s ({len(files)} files, batch 64, "
                f"WAV decode included); launches {counts[label]}")
        names = list(routes)
        n_layers, n_conv = wcfg.num_layers, len(wcfg.conv_dims)
        n_k3 = sum(k == 3 for k in wcfg.conv_kernels[1:])
        want_counts = {
            names[0]: dict(expected),
            names[1]: {**{k: 0 for k in expected},
                       "flash_attention_varlen": forwards * n_layers,
                       "fused_ffn": forwards * n_layers, "pos_conv": forwards,
                       "conv_gemm_ln_gelu": forwards * (n_conv - n_k3),
                       "conv_k3_ln_gelu": forwards * n_k3},
            names[2]: {k: 0 for k in expected},
        }
        if counts != want_counts:
            raise AssertionError(f"extraction launch counts {counts}, expected "
                                 f"{want_counts}")
        log(f"extraction: waveform batches of the forwards {sorted(seen)}")
        if seen != set(EXTRACT_WAVES):
            raise AssertionError("the extraction forwards ran at other shapes "
                                 f"than the kernel phase held: {sorted(seen)}")
        worst = {}
        for label in names[:2]:
            rels = []
            for path, ref in embs[names[2]].items():
                got = embs[label][path]
                if files[os.path.basename(path)] == "short":
                    if np.abs(got).max() != 0.0 or np.abs(ref).max() != 0.0:
                        raise AssertionError("the 10 ms clip must embed to zero")
                    continue
                rels.append(_rel_l2(got, ref))
            worst[label] = max(rels)
            log(f"extraction, {label} vs plain: rel-L2 per clip max "
                f"{max(rels):.3e}, mean {float(np.mean(rels)):.3e} (limit "
                f"{EMBED_REL_L2})")
            if not np.isfinite(rels).all() or max(rels) >= EMBED_REL_L2:
                raise AssertionError(f"{label}: audio embeddings moved beyond "
                                     "the feature-noise contract")
        # The CLI's artifacts are the default route's embeddings in float16.
        for path, emb in embs[names[0]].items():
            name = os.path.basename(path)
            if np.abs(cli[name] - emb.astype(np.float16).astype(np.float32)).max() \
                    > 2 ** -10:
                raise AssertionError(f"{name}: the CLI's artifact differs from "
                                     "iter_audio_embeddings")
        all_kernel_launches = counts[names[1]]
        del default, all_kernel, plain, state
        # The folder's waves in the order the embedders read them (phase 9).
        waves = [load_waveform(p, wcfg.sample_rate)
                 for p in iter_audio_files(in_dir)]

    # 3. Video: 24 seeded chunks = three device batches, serial and pipelined.
    extractor = extract.VideoFeatureExtractor(vcfg, device=dev)
    chunks = rng.integers(0, 256, dtype=np.uint8, size=(
        24, vcfg.num_frames, *vcfg.image_size, vcfg.in_channels))
    # Warm-up of both routes (the pipelined one allocates pinned buffers,
    # which PyTorch's host allocator keeps), then four readings of each.
    extractor.embed_chunks(chunks[:16], pipeline=False)
    extractor.embed_chunks(chunks, pipeline=True)
    outs, secs = {}, {False: [], True: []}
    for pipeline in (False, True, True, False, False, True, True, False):
        reset_launches()
        t0 = time.perf_counter()
        outs[pipeline] = extractor.embed_chunks(chunks, pipeline=pipeline)
        torch.cuda.synchronize()
        secs[pipeline].append(time.perf_counter() - t0)
        got = read_launches()
        want = {k: 0 for k in got}
        want.update(flash_attention=3 * vcfg.depth, fused_ffn=3 * vcfg.depth)
        if got != want:
            raise AssertionError(f"embed_chunks launch counts {got}, expected "
                                 f"{want}")
    if not np.array_equal(outs[False], outs[True]) \
            or outs[True].shape != (24, vcfg.dim) \
            or not np.isfinite(outs[True]).all():
        raise AssertionError("embed_chunks(pipeline=True) differs from "
                             "pipeline=False")
    for pipeline in (False, True):
        log(f"extraction, embed_chunks pipeline={pipeline}: "
            + ", ".join(f"{s * 1e3:.1f} ms ({24 / s:.1f} chunks/s)"
                        for s in secs[pipeline])
            + "; 24 chunks, identical rows, attention and FFN launches 36 each")
    return {"cli": cli_launches, "all_kernel": all_kernel_launches,
            "chunks": chunks, "waves": waves}


# -- phase 9: the scale-out paths on a one-rank NCCL world ------------------------

SCALE_OUT_LIMIT_S = 60.0
# The numpy-route load reads every 4th of the 8,496 pairs.
NUMPY_LOAD_STRIDE = 4
SCALE_OUT_EPOCHS = 2
# The global batch of the phase's training runs: a dp4 run's 4 x 64 rows.
SCALE_OUT_BATCH = 256


def _same_rows(tag: str, got, want) -> None:
    if got != want:
        raise AssertionError(f"{tag}: the mesh run's rows differ from the "
                             f"single-device run's:\n{got}\n{want}")


def run_scale_out(dev, chunks, waves, features: str) -> dict:
    """Phase 9: the mesh paths (``core/mesh.py``) through a real NCCL process
    group of one rank on the card, each held bit for bit to the single-device
    path with exact kernel launches: ``VideoFeatureExtractor(mesh=)`` on the
    extraction phase's 24 chunks, ``AudioEmbedder(mesh=)`` on its 96 waves
    (both routes), the native load of the training phase's 8,496 pairs
    (its folders under ``features``) against numpy's,
    ``train_model(mesh_cfg=MeshConfig())`` on them, the streaming trainer
    over the same folders (native loader), the scaling probe at n = 1 and
    ``core.check``'s matmul rate.  Returns the mesh runs' launch counts."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from mmer_tpu_torch.config import (DataConfig, MeshConfig, ModelConfig,
                                       TrainConfig, ViViTConfig, Wav2Vec2Config)
    from mmer_tpu_torch.core import check
    from mmer_tpu_torch.core.mesh import create_mesh
    from mmer_tpu_torch.data.catalog import build_catalog
    from mmer_tpu_torch.data.pipeline import (dataset_from_features,
                                              load_feature_arrays)
    from mmer_tpu_torch.data.streaming import StreamingFeatureDataset
    from mmer_tpu_torch.models.wav2vec2 import AudioEmbedder
    from mmer_tpu_torch.parallel import scaling
    from mmer_tpu_torch.parallel.launch import free_port
    from mmer_tpu_torch.preprocess.extract import VideoFeatureExtractor
    from mmer_tpu_torch.train.loop import train_model
    from mmer_tpu_torch.train.streaming import train_streaming

    t_phase = time.perf_counter()

    def log(msg: str) -> None:
        print(f"{msg} [{time.perf_counter() - t_phase:.2f} s into the phase]",
              flush=True)

    log(f"scale-out: {torch.cuda.device_count()} card(s); a one-rank NCCL world "
        "on cuda:0 -- no multi-rank run takes place on this card")
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)
    mesh_launches = {k: 0 for k in read_launches()}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def mesh_run(fn):
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = read_launches()
        for k, v in got.items():
            mesh_launches[k] += v
        return out, got

    try:
        mesh = create_mesh(MeshConfig())
        if not mesh.active or mesh.backend != "nccl" or mesh.shape != {"data": 1, "model": 1}:
            raise AssertionError(f"scale-out: mesh {mesh.shape} on {mesh.backend}")

        # Video: the extraction phase's 24 chunks, serial and pipelined.
        vcfg = ViViTConfig()
        solo = VideoFeatureExtractor(vcfg, device=dev)
        sharded = VideoFeatureExtractor(vcfg, device=dev, mesh=mesh,
                                        params=solo.model.state_dict())
        reset_launches()
        want = solo.embed_chunks(chunks)
        want_launches = read_launches()
        for pipeline in (False, True):
            got, launches = mesh_run(lambda: sharded.embed_chunks(chunks, pipeline=pipeline))
            if not np.array_equal(got, want) or launches != want_launches:
                raise AssertionError(f"scale-out video (pipeline={pipeline}): "
                                     f"bits equal {np.array_equal(got, want)}, "
                                     f"launches {launches} vs {want_launches}")
        secs = [timed(lambda: e.embed_chunks(chunks))[1]
                for e in (solo, sharded, sharded, solo)]
        log(f"scale-out: VideoFeatureExtractor(mesh=) on {len(chunks)} chunks, "
            f"serial and pipelined: bit-equal to the single-device rows; launches "
            f"{ {k: v for k, v in want_launches.items() if v} } a call; single "
            f"device {secs[0] * 1e3:.2f} / {secs[3] * 1e3:.2f} ms, mesh "
            f"{secs[1] * 1e3:.2f} / {secs[2] * 1e3:.2f} ms a call")

        # Audio: the 96 waves in the extraction phase's batches, both routes.
        wcfg = Wav2Vec2Config()
        default = AudioEmbedder(wcfg, device=dev)
        state = default.model.state_dict()
        routes = {"default": dict(), "all-kernel": dict(use_flash_attn=True, mega=False)}
        for label, kw in routes.items():
            solo_a = default if not kw else AudioEmbedder(wcfg, device=dev, params=state, **kw)
            mesh_a = AudioEmbedder(wcfg, device=dev, params=state, mesh=mesh, **kw)

            def embed(embedder):
                return np.concatenate([embedder.embed_batch(waves[i:i + 64])
                                       for i in range(0, len(waves), 64)])

            reset_launches()
            want = embed(solo_a)
            want_launches = read_launches()
            got, launches = mesh_run(lambda: embed(mesh_a))
            if not np.array_equal(got, want) or launches != want_launches:
                raise AssertionError(f"scale-out audio ({label}): bits equal "
                                     f"{np.array_equal(got, want)}, launches "
                                     f"{launches} vs {want_launches}")
            secs = [timed(lambda: embed(e))[1] for e in (solo_a, mesh_a)]
            log(f"scale-out: AudioEmbedder(mesh=) {label} route on {len(waves)} "
                f"waves: bit-equal; launches "
                f"{ {k: v for k, v in launches.items() if v} }; single device "
                f"{secs[0] * 1e3:.1f} ms, mesh {secs[1] * 1e3:.1f} ms for the "
                "two batches")
            del solo_a, mesh_a
        del default, state, solo, sharded

        video_dir, audio_dir = (os.path.join(features, d) for d in ("video", "audio"))

        # The native loader against numpy's: all pairs natively, every
        # NUMPY_LOAD_STRIDE-th through numpy (all of them took 10-26 s, a
        # third to a half of the phase).
        catalog = build_catalog(video_dir, audio_dir, "key")
        n = len(catalog)
        if n != sum(CLASS_COUNTS):
            raise AssertionError(f"scale-out: {n} pairs in the training phase's folders")
        t0 = time.perf_counter()
        v1, a1 = load_feature_arrays(catalog, use_native=True)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        v2, a2 = load_feature_arrays(catalog[::NUMPY_LOAD_STRIDE], use_native=False)
        numpy_s = time.perf_counter() - t0
        n2 = len(v2)
        if not (np.array_equal(a1[::NUMPY_LOAD_STRIDE], a2) and len(v1) == n
                and all(np.array_equal(x, y)
                        for x, y in zip(v1[::NUMPY_LOAD_STRIDE], v2))):
            raise AssertionError("scale-out: the native load differs from numpy's")
        log(f"scale-out: {n} pairs loaded natively in {native_s:.3f} s "
            f"({native_s / n * 1e3:.3f} ms a pair), every {NUMPY_LOAD_STRIDE}th "
            f"({n2}) through numpy in {numpy_s:.3f} s ({numpy_s / n2 * 1e3:.3f} "
            "ms a pair); equal arrays")

        # Training: single device, then the one-rank mesh, same seed, on
        # load_dataset's arrays from the native load above.
        data, splits = dataset_from_features(
            v1, a1, np.asarray([e.label for e in catalog], np.int32),
            [e.key for e in catalog], DataConfig(video_feat_dir=video_dir,
                                                 audio_feat_dir=audio_dir))
        model_cfg = ModelConfig(max_seq_len=data.max_chunks + 1)
        train_cfg = TrainConfig(num_epochs=SCALE_OUT_EPOCHS, lr=1e-4,
                                save_checkpoints=False)
        solo_out = train_model(data, splits, model_cfg, train_cfg,
                               batch_size=SCALE_OUT_BATCH, verbose=False, device=dev)
        mesh_out, launches = mesh_run(lambda: train_model(
            data, splits, model_cfg, train_cfg, batch_size=SCALE_OUT_BATCH,
            verbose=False, device=dev, mesh_cfg=MeshConfig()))
        _same_rows("train_model", mesh_out.results, solo_out.results)
        for k, v in solo_out.final_params.items():
            if not torch.equal(mesh_out.final_params[k], v):
                raise AssertionError(f"scale-out: final weight {k} differs")
        if mesh_out.hyperparameters["mesh"] != {"data": 1, "model": 1} \
                or any(launches.values()):
            raise AssertionError(f"scale-out: run log mesh "
                                 f"{mesh_out.hyperparameters['mesh']}, "
                                 f"launches {launches}")
        log(f"scale-out: train_model(mesh_cfg=MeshConfig()) {SCALE_OUT_EPOCHS} "
            "epochs: rows and final weights bit-equal to the single-device "
            f"run's, run log mesh {mesh_out.hyperparameters['mesh']}; training "
            "pass " + ", ".join(f"{s:.3f}" for s in mesh_out.train_epoch_seconds)
            + " s an epoch (single device " + ", ".join(
                f"{s:.3f}" for s in solo_out.train_epoch_seconds) + ")")

        # Mid-run checkpoints over the mesh: a run cut after epoch 1 (a
        # checkpoint every epoch) and resumed repeats the uninterrupted mesh
        # run's later epochs bit for bit.
        with tempfile.TemporaryDirectory(prefix="mmer_smoke_resume_") as ckpt_root:
            cut_cfg = dataclasses.replace(train_cfg, num_epochs=1,
                                          checkpoint_every=1,
                                          output_dir=ckpt_root)
            mesh_run(lambda: train_model(
                data, splits, model_cfg, cut_cfg, batch_size=SCALE_OUT_BATCH,
                verbose=False, device=dev, mesh_cfg=MeshConfig()))
            resumed, _ = mesh_run(lambda: train_model(
                data, splits, model_cfg, train_cfg, batch_size=SCALE_OUT_BATCH,
                verbose=False, device=dev, mesh_cfg=MeshConfig(),
                resume_dir=os.path.join(ckpt_root, "checkpoints")))
        _same_rows("resumed train_model", resumed.results, mesh_out.results[1:])
        for k, v in mesh_out.final_params.items():
            if not torch.equal(resumed.final_params[k], v):
                raise AssertionError(f"scale-out: resumed final weight {k} differs")
        log("scale-out: a mesh train_model cut after epoch 1 and resumed from "
            "its checkpoint: its later epochs' rows and the final weights "
            "bit-equal to the uninterrupted mesh run's")

        # The streaming trainer over the same folders.
        stats = {k: getattr(data, k) for k in ("video_mean", "video_std",
                                               "audio_mean", "audio_std")}
        train_ds = StreamingFeatureDataset([catalog[i] for i in splits.train],
                                           SCALE_OUT_BATCH, data.max_chunks,
                                           norm_stats=stats)
        val_ds = StreamingFeatureDataset([catalog[i] for i in splits.val],
                                         SCALE_OUT_BATCH, data.max_chunks,
                                         norm_stats=stats)
        t0 = time.perf_counter()
        stream = train_streaming(train_ds, val_ds, model_cfg, train_cfg,
                                 splits.class_weights, verbose=False, device=dev)
        torch.cuda.synchronize()
        stream_s = (time.perf_counter() - t0) / SCALE_OUT_EPOCHS
        rows = stream["results"]
        losses = [r[k] for r in rows for k in ("train_loss", "val_loss")]
        if len(rows) != SCALE_OUT_EPOCHS or not np.isfinite(losses).all() \
                or train_ds.native_batches != SCALE_OUT_EPOCHS * len(train_ds) \
                or val_ds.native_batches != SCALE_OUT_EPOCHS * len(val_ds):
            raise AssertionError(f"scale-out: streaming rows {rows}, native "
                                 f"batches {train_ds.native_batches} / "
                                 f"{val_ds.native_batches}")
        wall = mesh_out.hyperparameters["train_wall_seconds"] / SCALE_OUT_EPOCHS
        log(f"scale-out: train_streaming {SCALE_OUT_EPOCHS} epochs, every "
            f"batch through the native loader: {stream_s:.3f} s an epoch "
            f"with its evaluation, against {wall:.3f} s for train_model's "
            "in-memory epochs; train loss "
            + ", ".join(f"{r['train_loss']:.4f}" for r in rows))

        # The scaling probe at n = 1, and the matmul rate.
        for leg, fn in (("extract", lambda: scaling.measure_extract_scaling(1, device=dev)),
                        ("train", lambda: scaling.measure_train_scaling(1, device=dev))):
            print(json.dumps({"scaling": leg, **fn()}), flush=True)
        rate = check.matmul_rate()
        log(f"scale-out: core.check bf16 {rate['n']}^3 matmul {rate['ms']:.4f} ms, "
            f"{rate['tflops']:.1f} TFLOP/s")
    finally:
        dist.destroy_process_group()
    phase_s = time.perf_counter() - t_phase
    log(f"scale-out: phase {phase_s:.2f} s wall (limit {SCALE_OUT_LIMIT_S} s)")
    if phase_s > SCALE_OUT_LIMIT_S:
        raise AssertionError("the scale-out phase took too long")
    return mesh_launches


# Phase 10, the prep chain on raw frames: full_chain's chain and recipe.
PREP_ACTORS = 10
PREP_FRAMES = (40, 73)          # 40-72 frames: 2-3 subchunks of 32
PREP_EPOCHS = 60
# Clip i of an actor: 1 and 4 tilt the face by +30 / -30 degrees, 2 and 5
# cover its bottom 40 % with a bar, on frames 8-23.
PREP_EXTRAS = {1: {"tilt": (30.0, 8, 24)}, 4: {"tilt": (-30.0, 8, 24)},
               2: {"occlusion": (0.4, 8, 24)}, 5: {"occlusion": (0.4, 8, 24)}}


def _plain_twins(dev, records: dict) -> None:
    """Every ViViT and Wav2Vec2 call a run recorded, re-run on the plain
    route (same weights, bf16) and on the f32 path.  The first call of each
    kind is the chain's extraction, the rest serve the probes; over each of
    those groups' rows the kernel route must be no further from the f32
    path than the plain route is, within VIDEO_F32_FACTOR.  Each call's
    distances are logged.  A call of one or two rows is too few for the
    ratio, and the per-clip 0.5 % audio gate cannot bind here: on 1 s
    serving windows the plain route itself sits ~0.95 % from the f32 path
    (PERF.md, Findings)."""
    import numpy as np

    from mmer_tpu_torch.models.wav2vec2 import AudioEmbedder
    from mmer_tpu_torch.preprocess.extract import VideoFeatureExtractor

    f32 = dataclasses.replace
    for kind, cls, embed in (("video", VideoFeatureExtractor, "embed_chunks"),
                             ("audio", AudioEmbedder, "embed_batch")):
        twins, rows = {}, []
        for i, (obj, x, got) in enumerate(records[kind]):
            if id(obj) not in twins:
                sd = obj.model.state_dict()
                twins[id(obj)] = [
                    cls(obj.cfg, device=dev, use_kernels=False, params=sd),
                    cls(f32(obj.cfg, compute_dtype="float32"), device=dev,
                        use_kernels=False, params=sd)]
            plain, exact = (getattr(t, embed)(x) for t in twins[id(obj)])
            rows.append((got, plain, exact))
            log(f"prep chain: {kind} call {i} ({len(got)} rows): kernel vs "
                f"plain rel-L2 {_rel_l2(got, plain):.3e}; vs the f32 path: "
                f"kernel {_rel_l2(got, exact):.3e}, plain "
                f"{_rel_l2(plain, exact):.3e}")
        del twins
        for group, calls in (("extraction", rows[:1]), ("serving", rows[1:])):
            got, plain, exact = (np.concatenate(a) for a in zip(*calls))
            r_k32, r_p32 = _rel_l2(got, exact), _rel_l2(plain, exact)
            log(f"prep chain: {kind} {group}, {len(got)} rows: vs the f32 path "
                f"kernel {r_k32:.3e}, plain {r_p32:.3e} (limit "
                f"{VIDEO_F32_FACTOR} x plain)")
            if r_k32 > VIDEO_F32_FACTOR * r_p32:
                raise AssertionError(f"prep chain: the kernels move {kind} "
                                     f"{group} embeddings further from f32 "
                                     "than the plain bf16 route")


def run_prep_chain(dev) -> dict:
    """Phase 10: ``scripts/full_chain.py:run_chain`` on raw frames in memory
    (the card has no container codec): 60 raw 360x480 clips (10 actors x 6
    emotions, 40-72 frames, tilted and occluded runs) → the tracker with
    the native cascade and its ``.txt`` files → face crops on the card,
    each batch held to the CPU's → the default ViViT-B and Wav2Vec2-large →
    ``dataset_from_feature_maps``, equal to the disk route's arrays →
    ``train.cli`` at full_chain's recipe → six held-out clips through
    ``InferenceEngine.infer_frames`` and the span-weighted vote.  Every
    extractor call of the chain is then re-run on the plain route
    (:func:`_plain_twins`), and one 720x1280 clip is tracked, timed.
    Returns the chain's kernel launches."""
    import numpy as np
    import torch

    from mmer_tpu_torch.models.wav2vec2 import AudioEmbedder
    from mmer_tpu_torch.preprocess.extract import VideoFeatureExtractor
    from mmer_tpu_torch.preprocess.faces import (HaarFaceDetector, TrackStats,
                                                 extract_frame_bboxes)
    from mmer_tpu_torch.scripts import full_chain as fc

    t_phase = time.perf_counter()

    def log(msg: str) -> None:
        print(f"prep chain: {msg.strip()} [{time.perf_counter() - t_phase:.2f} "
              "s into the phase]", flush=True)

    detector = HaarFaceDetector()
    if detector.engine != "native":
        raise AssertionError(f"prep chain: the cascade runs on the "
                             f"{detector.engine} engine, not the native one")
    probes = list(fc.make_clips(1, np.random.default_rng(11), PREP_FRAMES,
                                first_actor=1001 + PREP_ACTORS,
                                extras=PREP_EXTRAS))
    clips = fc.make_clips(PREP_ACTORS, np.random.default_rng(10), PREP_FRAMES,
                          extras=PREP_EXTRAS)

    # Every extractor call is recorded (inputs and result) for the plain
    # route's re-run, and each Wav2Vec2 forward's waveform batch is logged.
    records = {"video": [], "audio": []}
    waves_seen = []
    embed_chunks, embed_batch = (VideoFeatureExtractor.embed_chunks,
                                 AudioEmbedder.embed_batch)

    def record_video(self, chunks, pipeline=False):
        out = embed_chunks(self, chunks, pipeline)
        x = chunks.clone() if torch.is_tensor(chunks) else chunks
        records["video"].append((self, x, out))
        return out

    def record_audio(self, waveforms):
        if not any(obj is self for obj, _, _ in records["audio"]):
            self.model.register_forward_pre_hook(
                lambda _, args: waves_seen.append(tuple(args[0].shape)))
        out = embed_batch(self, waveforms)
        records["audio"].append((self, list(waveforms), out))
        return out

    VideoFeatureExtractor.embed_chunks = record_video
    AudioEmbedder.embed_batch = record_audio
    root = tempfile.TemporaryDirectory(prefix="mmer_smoke_prep_")
    try:
        reset_launches()
        result = fc.run_chain(clips, probes, root.name, dev,
                              epochs=PREP_EPOCHS, log=log)
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        VideoFeatureExtractor.embed_chunks = embed_chunks
        AudioEmbedder.embed_batch = embed_batch
        root.cleanup()
    track = result.track
    log(f"tracker on {result.clips} clips of 360x480, {track.frames} frames: "
        f"{result.track_s / track.frames * 1e3:.2f} ms a frame (host); rows "
        f"full {track.full}, relaxed {track.relaxed}, tracked {track.tracked}, "
        f"interpolated {track.interpolated}; crops on the card "
        f"{result.crop_s / track.frames * 1e3:.3f} ms a frame with the copies, "
        f"every batch within {result.crop_worst} grey level of the CPU's; "
        f"Wav2Vec2 waveform batches {waves_seen}")
    if track.relaxed < 1 or track.tracked < 1:
        raise AssertionError("prep chain: the relaxed re-detection or the "
                             "NCC tracker never fired")
    if waves_seen[0] != PREP_WAVES:
        raise AssertionError(f"prep chain: the extraction forward ran at "
                             f"{waves_seen[0]}, not the kernel phase's "
                             f"{PREP_WAVES}")
    _plain_twins(dev, records)
    del records

    # RAVDESS's frame size: one 32-frame 720x1280 clip, a 360-px face.
    big = fc.raw_clip_frames(fc.packaged_face(360), np.random.default_rng(12),
                             32, hw=(720, 1280))
    stats = TrackStats()
    t0 = time.perf_counter()
    extract_frame_bboxes(big, detector, stats=stats)
    big_s = time.perf_counter() - t0
    log(f"tracker on 32 frames of 720x1280: {big_s / 32 * 1e3:.2f} ms a frame "
        f"(host); rows full {stats.full}, relaxed {stats.relaxed}, tracked "
        f"{stats.tracked}")
    phase_s = time.perf_counter() - t_phase
    log(f"best test acc {result.best_acc:.1f}% (needs > 80), serving recovery "
        f"{result.hits}/{len(result.votes)} (needs >= 5); launches "
        f"{ {k: v for k, v in launches.items() if v} }; embedding "
        f"{result.embed_s:.2f} s, training {result.train_s:.2f} s, serving "
        f"{result.serve_s:.2f} s; phase {phase_s:.2f} s wall")
    if not result.ok:
        raise AssertionError("prep chain: full_chain's thresholds missed")
    return launches


if __name__ == "__main__":
    sys.exit(main())
