"""Video → per-window emotion inference, the port of ``mmer_tpu/serve/engine.py``.

The request path of ``infer_video_file`` (reference
back-end/app/libs/inference.py:356-524): decode the upload frame by frame,
detect a face per frame (or every ``detect_every``-th frame, carrying the
boxes forward), group face frames into gap-tolerant sequences, crop each
face frame on the device and embed its 32-frame subchunks with ViViT as the
frames stream in (:class:`~mmer_tpu_torch.preprocess.extract.SubchunkStream`),
slide a window of up to 5 subchunks, embed each window's audio slice with
Wav2Vec2 in one batch, classify the windows with the fusion model grouped by
token count, and answer ``{"bounding_box": [...], "inference": [...]}``,
with Integrated-Gradients feature importances when ``explain`` is set.

Entry points:

- :meth:`InferenceEngine.infer_video_file` / :meth:`infer_file_bytes`: a
  container (``cv2`` decodes it: ``preprocess/video.iter_video_frames``);
- :meth:`InferenceEngine.infer_frames`: the same from decoded RGB frames,
  the frame rate and a waveform, with no ``cv2``;
- :meth:`InferenceEngine.predict_clip` / :meth:`predict_chunks`: whole-clip
  prediction (reference back-end/app/inference.py:27-163);
- :meth:`InferenceEngine.infer_sequence`: the window stage for one face
  sequence of already-cropped subchunks.

On a CUDA device the extractors always run the hand-written kernels.
Fusion checkpoints are ``.pth`` files (the port's own state dict, what
``train.cli`` writes, or a reference v2 state dict, ``models/port_fusion``)
or flax ``.msgpack`` params trees (the JAX trainer's and the flagship's);
comma-separated paths, of either kind, are served as a mean-probability
ensemble.

A fresh process pays at its first request for what no earlier call made:
``nvcc`` for a kernel library missing from the build directory
(``ops/_build.py``), each library's first load and launch, the CUDA context,
cuBLAS / cuDNN handles and their choice for each new shape, the caching
allocator's growth and the seeded weight trees.  :meth:`InferenceEngine.warmup`
pays for them before the first upload, stage by stage in the JAX engine's
order.  The JAX engine's compile-cache opt-ins (``_auto_mosaic_opt_in``,
``core/aot.py``) have no counterpart: the port has no compile to trade
against a faster request.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mmer_tpu_torch.config import LABELS, ModelConfig, ViViTConfig, Wav2Vec2Config
from mmer_tpu_torch.core.buckets import batch_bucket, resolution_bucket

# Gap-tolerant face sequences (faces.group_face_sequences semantics).
MAX_DELAY, MAX_SEQ_FRAMES = 10, 10000
# Integrated Gradients of a served window: Gauss-Legendre, 50 nodes.
IG_STEPS, IG_METHOD = 50, "gausslegendre"
STAGES = ("detect", "crop_vivit", "audio", "fusion", "ig")


def canonicalize_frame(rgb: np.ndarray, bboxes: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Map an upload frame onto the bounded frame-size family
    (``core/buckets.resolution_bucket``): edge-replication pad up to the
    ladder rung (in-bounds crops keep their bits), downscaling first only
    when the frame exceeds the top rung (bboxes scale along; ``cv2`` does
    that resize, as in the JAX engine)."""
    h, w = rgb.shape[:2]
    (ch, cw), scale = resolution_bucket(h, w)
    bboxes = np.asarray(bboxes, np.float32)
    if scale < 1.0:
        import cv2
        nh = min(int(round(h * scale)), ch)
        nw = min(int(round(w * scale)), cw)
        rgb = cv2.resize(rgb, (nw, nh))
        bboxes = bboxes * scale
        h, w = nh, nw
    if (h, w) != (ch, cw):
        rgb = np.pad(rgb, ((0, ch - h), (0, cw - w), (0, 0)), mode="edge")
    return rgb, bboxes


def window_audio_slices(seq_frames_idx: Sequence[int],
                        win_lens: Sequence[int], subchunk_size: int,
                        fps: float, sample_rate: int
                        ) -> List[Tuple[int, int]]:
    """Per-window waveform sample ranges ``[lo, hi)`` for a face sequence.

    Window ``s`` covers subchunks ``s..s+win_lens[s]``; its audio runs from
    the time of the window's first video frame to just past its last.
    ``seq_frames_idx`` holds the original frame numbers, so dropped frames
    stretch the span.  Ranges are non-empty (``hi ≥ lo + 1``); callers clip
    against the waveform length."""
    slices: List[Tuple[int, int]] = []
    n_frames = len(seq_frames_idx)
    for s, wl in enumerate(win_lens):
        f_lo = seq_frames_idx[min(s * subchunk_size, n_frames - 1)]
        last = min((s + wl) * subchunk_size, n_frames) - 1
        f_hi = seq_frames_idx[last]
        lo = int(f_lo / fps * sample_rate)
        hi = int((f_hi + 1) / fps * sample_rate)
        slices.append((lo, max(hi, lo + 1)))
    return slices


def _topk_importance(video_imp: np.ndarray, audio_imp: np.ndarray,
                     top_k: int = 10) -> Dict:
    def top(arr):
        idx = np.argsort(-np.abs(arr))[:top_k]
        return [{"dimension": int(i), "importance": float(arr[i])}
                for i in idx]

    return {"video": top(video_imp), "audio": top(audio_imp)}


def _launch_counters() -> Dict[str, Tuple[object, str]]:
    """Every kernel wrapper's launch counter as (owner, attribute), by the
    kernel's name: the FFN's reduce pass and the attention probe's per-mode
    dict included."""
    from mmer_tpu_torch.ops import (attention_variants, conv_pyramid,
                                    flash_attention, fused_blocks, prng, quant)

    return {
        "flash_attention": (flash_attention.flash_attention, "launches"),
        "flash_attention_varlen": (flash_attention.flash_attention_varlen,
                                   "launches"),
        "fused_ffn": (fused_blocks.fused_ffn, "launches"),
        "fused_ffn_reduce": (fused_blocks.fused_ffn, "reduce_launches"),
        "fused_ln_matmul": (fused_blocks.fused_ln_matmul, "launches"),
        "fused_conv_encoder": (conv_pyramid.fused_conv_encoder, "launches"),
        "conv_gemm_ln_gelu": (conv_pyramid._call_gemm, "launches"),
        "conv_k3_ln_gelu": (conv_pyramid._call_k3, "launches"),
        "threefry": (prng.launch_threefry, "launches"),
        "row_quant": (quant.row_quant, "launches"),
        "qdot_int8": (quant.qdot_int8, "launches"),
        "qdot_u8": (quant.qdot_u8, "launches"),
        "attention_variant": (attention_variants.attention_variant, "launches"),
    }


def _read_counters(counters: Dict[str, Tuple[object, str]]) -> Dict[str, object]:
    saved = {}
    for name, (owner, attr) in counters.items():
        value = getattr(owner, attr)
        saved[name] = dict(value) if isinstance(value, dict) else value
    return saved


def _restore_counters(counters: Dict[str, Tuple[object, str]],
                      saved: Dict[str, object]) -> Dict[str, int]:
    """Put the counters back to ``saved``; return the launches made since,
    by kernel (the probe's modes as ``attention_variant[mode]``)."""
    made: Dict[str, int] = {}
    for name, (owner, attr) in counters.items():
        now, before = getattr(owner, attr), saved[name]
        if isinstance(now, dict):
            made.update({f"{name}[{k}]": now[k] - before.get(k, 0) for k in now})
            now.clear()
            now.update(before)
        else:
            made[name] = now - before
            setattr(owner, attr, before)
    return made


class EnsembleFusion(nn.Module):
    """Fusion models of one config served as one program: the members'
    parameters stacked (``models/fusion.stack_members``) and the forward
    ``torch.vmap``-ed over them (``member_forward``).  ``forward``
    returns (mean probabilities, mean logits, None): the mean
    probabilities pick the class (the ensemble's blend), the mean logits
    are its IG target function."""

    def __init__(self, members: Sequence[nn.Module]):
        super().__init__()
        from mmer_tpu_torch.models.fusion import stack_members

        self.members = len(members)
        self._base, params, self._buffers_stacked = stack_members(members)
        self._params = {k: v.detach() for k, v in params.items()}

    def forward(self, video, audio, pad_mask=None):
        from mmer_tpu_torch.models.fusion import member_forward

        def one(p, b):
            probs, logits, _ = member_forward(self._base, p, b, video, audio,
                                              pad_mask)
            return probs, logits

        probs, logits = torch.vmap(one)(self._params, self._buffers_stacked)
        return probs.mean(0), logits.mean(0), None


class InferenceEngine:
    """Lazily built detector, extractors and fusion model on one device.

    ``device`` is required: ``"cuda"`` raises when CUDA is unavailable.
    ``fusion_params_path``: a ``.pth`` checkpoint (the port's own state
    dict or a reference v2 one) or a flax ``.msgpack`` one (shape
    mismatches raise), or several joined
    by commas for an ensemble; without it the fusion weights are the JAX
    engine's seeded ones (init key ``PRNGKey(0)``), drawn without JAX.  After each :meth:`infer_frames` call
    :attr:`last_timings` holds the seconds spent in each of ``STAGES`` and
    the frame counts.
    """

    def __init__(self, device: torch.device | str, *,
                 model_cfg: Optional[ModelConfig] = None,
                 vivit_cfg: Optional[ViViTConfig] = None,
                 wav_cfg: Optional[Wav2Vec2Config] = None,
                 fusion_params_path: Optional[str] = None,
                 vivit_params_path: Optional[str] = None,
                 wav_params_path: Optional[str] = None,
                 detector=None,
                 norm_stats: Optional[dict] = None,
                 norm_stats_path: Optional[str] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("InferenceEngine: CUDA device requested but "
                               "torch.cuda.is_available() is False")
        self.model_cfg = model_cfg or ModelConfig()
        self.vivit_cfg = vivit_cfg or ViViTConfig()
        self.wav_cfg = wav_cfg or Wav2Vec2Config()
        self.fusion_params_path = fusion_params_path
        self.vivit_params_path = vivit_params_path
        self.wav_params_path = wav_params_path
        self.labels = list(LABELS)
        if norm_stats is None and norm_stats_path:
            # Training-time global z-score stats (train/loop.py).
            with np.load(norm_stats_path) as z:
                norm_stats = {k: z[k] for k in z.files}
        self.norm_stats = norm_stats or {}
        self._detector = detector
        self._video_extractor = None
        self._audio_embedder = None
        self._fusion = None
        self._fusion_logits_fn = None
        self.last_timings: Dict[str, float] = {}
        self.last_warmup: Dict = {}

    @property
    def detector(self):
        if self._detector is None:
            from mmer_tpu_torch.preprocess.faces import default_detector
            self._detector = default_detector()
        return self._detector

    @property
    def video_extractor(self):
        if self._video_extractor is None:
            from mmer_tpu_torch.preprocess.extract import VideoFeatureExtractor
            self._video_extractor = VideoFeatureExtractor(
                self.vivit_cfg, device=self.device,
                params_path=self.vivit_params_path)
        return self._video_extractor

    @property
    def audio_embedder(self):
        if self._audio_embedder is None:
            from mmer_tpu_torch.models.wav2vec2 import AudioEmbedder
            self._audio_embedder = AudioEmbedder(
                self.wav_cfg, device=self.device,
                params_path=self.wav_params_path)
        return self._audio_embedder

    @property
    def fusion(self) -> nn.Module:
        """The fusion model, called as ``fusion(video, audio, pad_mask) ->
        (probs, logits, attn)``: loaded from ``fusion_params_path``, an
        :class:`EnsembleFusion` of several, or seeded."""
        if self._fusion is None:
            from mmer_tpu_torch.models.fusion import init_fusion
            from mmer_tpu_torch.models.jax_init import PRNGKey
            # Loud on a missing file, another format, a shape that
            # disagrees with model_cfg.
            from mmer_tpu_torch.train.checkpoint import load_fusion_checkpoint

            paths = [p.strip() for p in
                     (self.fusion_params_path or "").split(",") if p.strip()]
            members = [load_fusion_checkpoint(p, self.model_cfg, self.device)
                       for p in paths]
            if len(members) > 1:
                self._fusion = EnsembleFusion(members)
            elif members:
                self._fusion = members[0]
            else:
                # The JAX engine's seeded head: a jitted init under PRNGKey(0).
                self._fusion = init_fusion(self.model_cfg, device=self.device,
                                           key=PRNGKey(0), jitted=True)
        return self._fusion

    @property
    def fusion_logits_fn(self):
        """One stable logits closure ``(video, audio, mask) -> logits`` for
        IG: an ensemble's mean logits."""
        if self._fusion_logits_fn is None:
            fusion = self.fusion

            def logits_fn(v, a, m):
                return fusion(v, a, m)[1]

            self._fusion_logits_fn = logits_fn
        return self._fusion_logits_fn

    def _normalize(self, video_feats: np.ndarray, audio_feats: np.ndarray):
        """Apply training-time global z-score stats when available."""
        vm, vs = self.norm_stats.get("video_mean"), self.norm_stats.get("video_std")
        am, as_ = self.norm_stats.get("audio_mean"), self.norm_stats.get("audio_std")
        if vm is not None:
            video_feats = (video_feats - vm) / vs
        if am is not None:
            audio_feats = (audio_feats - am) / as_
        return video_feats, audio_feats

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _fusion_probs(self, video: np.ndarray, audio: np.ndarray,
                      mask: np.ndarray) -> np.ndarray:
        # Built outside inference mode: IG differentiates through the same
        # model, and weights made under inference mode cannot be.
        fusion = self.fusion
        with torch.inference_mode():
            probs, _, _ = fusion(self._dev(video.astype(np.float32)),
                                 self._dev(audio.astype(np.float32)),
                                 self._dev(mask))
            return probs.cpu().numpy()

    def _importances(self, video: np.ndarray, audio: np.ndarray,
                     mask: np.ndarray, targets: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """IG feature importances of a window batch at class ``targets``:
        (video (B, Dv), audio (B, Da))."""
        from mmer_tpu_torch.interpret.ig import (aggregate_importances,
                                                 integrated_gradients)

        av, aa = integrated_gradients(
            self.fusion_logits_fn, self._dev(video.astype(np.float32)),
            self._dev(audio.astype(np.float32)), self._dev(mask),
            self._dev(targets.astype(np.int64)), IG_STEPS, IG_METHOD)
        vi, ai = aggregate_importances(av, aa)
        return vi.detach().cpu().numpy(), ai.detach().cpu().numpy()

    def _clamp_window(self, window_size: int) -> int:
        max_tokens = self.model_cfg.max_seq_len - 1
        if window_size > max_tokens:
            print(f"window_size {window_size} exceeds the fusion model's "
                  f"{max_tokens} video slots; clamping", flush=True)
            window_size = max_tokens
        return window_size

    def _windows(self, sub_feats: np.ndarray, seq_frames_idx: Sequence[int],
                 waveform: Optional[np.ndarray], fps: float,
                 subchunk_size: int, window_size: int, explain: bool,
                 timings: Dict[str, float]) -> Tuple[List[Dict], np.ndarray]:
        """The window stage of one face sequence → (inference items,
        (n_sub, classes) probabilities)."""
        n_sub = sub_feats.shape[0]
        win_lens = [min(window_size, n_sub - s) for s in range(n_sub)]

        # Per-window audio slices, embedded in one batch.
        t0 = time.perf_counter()
        if waveform is not None:
            waves = []
            for lo, hi in window_audio_slices(seq_frames_idx, win_lens,
                                              subchunk_size, fps,
                                              self.wav_cfg.sample_rate):
                piece = waveform[lo:hi]
                waves.append(piece if len(piece) else np.zeros(1, np.float32))
            audio_embs = self.audio_embedder.embed_batch(waves)
        else:
            audio_embs = np.zeros((n_sub, self.model_cfg.audio_dim), np.float32)
        timings["audio"] += time.perf_counter() - t0

        # Windows batched by token count, batch sizes bucketed; padding rows
        # repeat the last window and are dropped.
        by_len: Dict[int, List[int]] = {}
        for s, wl in enumerate(win_lens):
            by_len.setdefault(wl, []).append(s)
        probs_all = np.zeros((n_sub, len(self.labels)), np.float32)
        importances: Dict[int, Dict] = {}
        for wl, starts in by_len.items():
            t0 = time.perf_counter()
            nb = len(starts)
            video_w = np.stack([sub_feats[s:s + wl] for s in starts])
            audio_w = audio_embs[starts]
            video_w, audio_w = self._normalize(video_w, audio_w)
            bp = batch_bucket(nb)
            if bp > nb:
                video_w = np.concatenate(
                    [video_w, np.repeat(video_w[-1:], bp - nb, axis=0)])
                audio_w = np.concatenate(
                    [audio_w, np.repeat(audio_w[-1:], bp - nb, axis=0)])
            mask = np.zeros((bp, wl), bool)
            probs = self._fusion_probs(video_w, audio_w, mask)
            probs_all[starts] = probs[:nb]
            timings["fusion"] += time.perf_counter() - t0
            if explain:
                # IG target: the window's predicted class.
                t0 = time.perf_counter()
                vi, ai = self._importances(video_w, audio_w, mask,
                                           np.argmax(probs, axis=-1))
                for row, s in enumerate(starts):
                    importances[s] = _topk_importance(vi[row], ai[row])
                timings["ig"] += time.perf_counter() - t0

        items = []
        for s in range(n_sub):
            first = s * subchunk_size
            frame = seq_frames_idx[first] if first < len(seq_frames_idx) else 0
            item = {"class": self.labels[int(np.argmax(probs_all[s]))],
                    "frame": int(frame)}
            if explain and s in importances:
                item["feature_importance"] = importances[s]
            items.append(item)
        return items, probs_all

    def infer_frames(self, frames: Iterable[np.ndarray], fps: float,
                     waveform: Optional[np.ndarray], subchunk_size: int = 32,
                     window_size: int = 5, explain: bool = False,
                     detect_every: int = 1) -> Dict:
        """Decoded upload → ``{"bounding_box", "inference",
        "probabilities"}``: the body of the JAX engine's
        ``infer_video_file`` after its ``cv2.VideoCapture``.

        ``frames`` yields (H, W, 3) uint8 RGB frames and is consumed once,
        frame by frame: at most one subchunk of raw frames and one device
        batch of crops are held.  ``waveform`` is the upload's 16 kHz audio
        track (None: zero audio embeddings).  ``detect_every=N`` runs the
        detector on every N-th frame and carries its boxes forward."""
        from mmer_tpu_torch.preprocess.extract import SubchunkStream

        window_size = self._clamp_window(window_size)
        timings = {k: 0.0 for k in STAGES}
        step = max(detect_every, 1)
        bounding_box: List[Dict] = []
        sequences: List[Tuple[List[int], np.ndarray]] = []   # (frames, feats)
        open_frames: List[int] = []
        open_stream: Optional[SubchunkStream] = None

        def close_sequence():
            nonlocal open_stream
            if open_stream is not None and open_frames:
                t0 = time.perf_counter()
                sequences.append((list(open_frames), open_stream.finish()))
                timings["crop_vivit"] += time.perf_counter() - t0
            open_stream = None
            open_frames.clear()

        idx = 0
        n_detected = 0
        carried: Optional[list] = None
        for rgb in frames:
            if idx % step == 0:
                t0 = time.perf_counter()
                carried = self.detector.detect(rgb)
                timings["detect"] += time.perf_counter() - t0
                n_detected += 1
            for (x1, y1, x2, y2, conf) in (carried or []):
                bounding_box.append({
                    "frame": idx, "x1": float(x1), "y1": float(y1),
                    "x2": float(x2), "y2": float(y2),
                    "confidence": float(conf)})
            if carried:
                best = max(carried, key=lambda r: r[4])
                if open_frames and (idx - open_frames[-1] > MAX_DELAY
                                    or len(open_frames) >= MAX_SEQ_FRAMES):
                    close_sequence()
                if open_stream is None:
                    open_stream = SubchunkStream(self.video_extractor,
                                                 subchunk_size)
                open_frames.append(idx)
                crgb, cbox = canonicalize_frame(
                    rgb, np.asarray(best[:4], np.float32)[None])
                t0 = time.perf_counter()
                open_stream.add(crgb[None], cbox)
                timings["crop_vivit"] += time.perf_counter() - t0
            idx += 1
        close_sequence()

        inference: List[Dict] = []
        probabilities: List[List[float]] = []
        for seq_frames_idx, sub_feats in sequences:
            items, probs = self._windows(sub_feats, seq_frames_idx, waveform,
                                         fps, subchunk_size, window_size,
                                         explain, timings)
            inference.extend(items)
            probabilities.extend(probs.tolist())
        timings.update(frames=idx, detected_frames=n_detected,
                       sequences=len(sequences))
        self.last_timings = timings
        return {"bounding_box": bounding_box, "inference": inference,
                "probabilities": probabilities}

    def infer_video_file(self, video_path: str, subchunk_size: int = 32,
                         window_size: int = 5, explain: bool = False,
                         detect_every: int = 1) -> Dict:
        """Reference ``infer_video_file`` contract (inference.py:356-524):
        ``{"bounding_box": [...], "inference": [...]}``.  The container is
        decoded with ``cv2``; its audio track comes from the PCM demux or
        ffmpeg (None → zero audio embeddings)."""
        from mmer_tpu_torch.preprocess.audio import extract_audio_track
        from mmer_tpu_torch.preprocess.video import iter_video_frames

        fps, frames = iter_video_frames(video_path)
        first = next(frames, None)
        if first is None:
            return {"bounding_box": [], "inference": []}

        def all_frames():
            yield first
            yield from frames

        # The audio track is decoded once, before the frames stream.
        waveform = extract_audio_track(video_path, self.wav_cfg.sample_rate)
        res = self.infer_frames(all_frames(), fps, waveform, subchunk_size,
                                window_size, explain, detect_every)
        return {"bounding_box": res["bounding_box"],
                "inference": res["inference"]}

    def infer_file_bytes(self, data: bytes, filename: str = "upload.mp4",
                         subchunk_size: int = 32, window_size: int = 5,
                         explain: bool = False, detect_every: int = 1) -> Dict:
        """Upload wrapper (reference infer_upload_file, inference.py:528-535)."""
        import tempfile

        with tempfile.TemporaryDirectory() as tmpdir:
            path = os.path.join(tmpdir, os.path.basename(filename) or "u.mp4")
            with open(path, "wb") as f:
                f.write(data)
            return self.infer_video_file(path, subchunk_size, window_size,
                                         explain, detect_every=detect_every)

    def _open_device_session(self) -> None:
        """The device's first round trip; on CUDA, then each kernel library
        of the request path (``ffn``, ``attention``, ``conv_encoder``) built
        where missing, loaded and launched once on zeros at the engine's
        widths.  A kernel that fails to build or launch raises."""
        torch.zeros((8, 128), device=self.device).add_(1.0).cpu()
        if self.device.type != "cuda":
            return
        from mmer_tpu_torch.ops.conv_pyramid import fused_conv_encoder
        from mmer_tpu_torch.ops.flash_attention import flash_attention
        from mmer_tpu_torch.ops.fused_blocks import fused_ffn

        dev, bf = self.device, torch.bfloat16

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        v = self.vivit_cfg
        fused_ffn(zeros(1, 1, v.dim, dtype=bf), zeros(v.dim) + 1, zeros(v.dim),
                  zeros(v.mlp_dim, v.dim, dtype=bf), zeros(v.mlp_dim),
                  zeros(v.dim, v.mlp_dim, dtype=bf), zeros(v.dim))
        q = zeros(1, v.heads, 8, v.dim_head, dtype=bf)
        flash_attention(q, q, q)
        w = self.wav_cfg
        weights, c_in = [], 1
        for c_out, k in zip(w.conv_dims, w.conv_kernels):
            weights.append(zeros(c_out, c_in, k))
            c_in = c_out
        samples = 1            # the receptive field of one output frame
        for k, stride in reversed(list(zip(w.conv_kernels, w.conv_strides))):
            samples = (samples - 1) * stride + k
        fused_conv_encoder(zeros(1, samples), weights,
                           [zeros(c) for c in w.conv_dims],
                           [zeros(c) + 1 for c in w.conv_dims],
                           [zeros(c) for c in w.conv_dims], w)
        torch.cuda.synchronize(dev)

    def warmup(self, subchunk_size: int = 32, window_size: int = 5,
               explain: bool = True,
               resolutions: Sequence[Tuple[int, int]] = (),
               fps: float = 30.0,
               sample_upload: Optional[bytes] = None,
               sample_detect_every: int = 3,
               sample_frames: Optional[Tuple[Iterable[np.ndarray], float,
                                             Optional[np.ndarray]]] = None
               ) -> None:
        """Run every stage of a default request once, so that the first
        real upload runs at steady-state latency: the JAX engine's
        ``warmup``, phase for phase.

        1. the device session (:meth:`_open_device_session`), then the face
           detector: its native evaluator, and its resampling pyramid at
           each format of ``resolutions`` (host state of the port's
           cascade, built at a frame size's first detection);
        2. the ViViT params and its forward on uint8 ``(1, subchunk_size,
           H, W, 3)`` (a ViViT block always pads to ``device_batch``
           chunks, so this is every request's ViViT shape);
        3. the crop route at each distinct ``resolution_bucket`` of
           ``resolutions`` ((height, width) formats, e.g. ``[(480, 640)]``);
        4. the Wav2Vec2 params and its forward at the 1 s bucket and at
           every bucket a window of at most ``window_size`` subchunks lands
           in at ``fps``;
        5. the fusion model, and IG when ``explain``, at each window length;
        6. a sample request, replayed end to end: ``sample_upload`` (the
           bytes of a video file, through :meth:`infer_file_bytes`, which
           needs ``cv2``) or ``sample_frames`` (``(frames, fps, waveform)``
           already decoded, through :meth:`infer_frames`), with detection
           every ``sample_detect_every`` frames.  It reaches what the
           enumeration misses: the Wav2Vec2 batch of a multi-window
           request's audio pieces (phase 4 runs one piece), the stages'
           host code and buffers.  A sample that gives no inference item
           warms none of that, and a WARNING says so.

        Prints each phase's seconds and the total.  Changes no state a
        later response depends on, and leaves the kernels' launch counters
        as it found them: :attr:`last_warmup` holds the phases' seconds, the
        launches the warmup made and the kernel libraries it built.  On a
        CUDA engine a kernel that fails to build or launch raises."""
        from mmer_tpu_torch.ops import _build

        if sample_upload is not None and sample_frames is not None:
            raise ValueError("warmup: pass sample_upload or sample_frames, "
                             "not both")
        t_start = last = time.perf_counter()
        phases: List[Tuple[str, float]] = []        # (name, seconds)
        counters = _launch_counters()
        saved = _read_counters(counters)
        builds0 = _build.builds
        timings = self.last_timings

        def phase(name):
            nonlocal last
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            now = time.perf_counter()
            phases.append((name, now - last))
            last = now

        try:
            self._open_device_session()
            phase("device session open (CUDA context; kernel libraries ffn, "
                  "attention, conv_encoder loaded and launched once)"
                  if self.device.type == "cuda" else "device session open")
            # The cascade's native evaluator, and its per-size resampling
            # pyramid at each listed format (a blank frame detects nothing).
            detector = self.detector
            getattr(detector, "engine", None)
            formats = list(dict.fromkeys((int(h), int(w)) for h, w in resolutions))
            for h, w in formats:
                detector.detect(np.zeros((h, w, 3), np.uint8))
            phase("face detector (native evaluator loaded, pyramids of "
                  f"{len(formats)} formats)")

            max_tokens = self.model_cfg.max_seq_len - 1
            window_size = min(window_size, max_tokens)
            # uint8, as the request path's crops are.
            chunks = np.zeros((1, subchunk_size, *self.vivit_cfg.image_size, 3),
                              np.uint8)
            _ = self.video_extractor
            phase("vivit params init")
            sub_feats = self.video_extractor.embed_chunks(chunks)
            phase("vivit forward")
            warmed = set()
            for h, w in resolutions:
                # Requests crop the canonical (bucketed) frame.
                (ch, cw), _ = resolution_bucket(h, w)
                if (ch, cw) in warmed:
                    continue
                warmed.add((ch, cw))
                frames = np.zeros((subchunk_size, ch, cw, 3), np.uint8)
                bboxes = np.tile(np.asarray([0, 0, cw, ch], np.float32),
                                 (subchunk_size, 1))
                self.video_extractor.embed_cropped_frames(frames, bboxes,
                                                          subchunk_size)
                phase(f"crop route {ch}x{cw} (bucket of {h}x{w})")
            _ = self.audio_embedder
            phase("w2v2 params init")
            self.audio_embedder.embed_batch(
                [np.zeros(self.wav_cfg.sample_rate, np.float32)])
            phase("w2v2 forward (1s bucket)")
            # A window of wl subchunks spans wl·subchunk_size frames, so its
            # audio piece lands in the ceil(wl·subchunk_size/fps) s bucket,
            # for every wl up to window_size; pieces past chunk_duration_s
            # are split, which caps the buckets.
            warmed_buckets = {1}
            for wl in range(1, window_size + 1):
                win_s = min(wl * subchunk_size / max(fps, 1e-6),
                            float(self.wav_cfg.chunk_duration_s))
                b = int(np.ceil(win_s))
                if b in warmed_buckets:
                    continue
                warmed_buckets.add(b)
                self.audio_embedder.embed_batch(
                    [np.zeros(b * self.wav_cfg.sample_rate, np.float32)])
                phase(f"w2v2 forward ({b}s bucket, window wl={wl})")
            _ = self.fusion
            phase("fusion params init+load")
            for wl in range(1, window_size + 1):
                video_w = np.tile(sub_feats[:1][None], (1, wl, 1)
                                  ).reshape(1, wl, -1)
                audio_w = np.zeros((1, self.model_cfg.audio_dim), np.float32)
                mask = np.zeros((1, wl), bool)
                self._fusion_probs(video_w, audio_w, mask)
                phase(f"fusion wl={wl}")
                if explain:
                    self._importances(video_w, audio_w, mask,
                                      np.zeros((1,), np.int64))
                    phase(f"IG wl={wl}")
            if sample_upload is not None or sample_frames is not None:
                if sample_upload is not None:
                    res = self.infer_file_bytes(
                        sample_upload, "warmup_sample.mp4",
                        subchunk_size=subchunk_size, window_size=window_size,
                        explain=explain, detect_every=sample_detect_every)
                else:
                    frames, sample_fps, waveform = sample_frames
                    res = self.infer_frames(
                        frames, sample_fps, waveform, subchunk_size,
                        window_size, explain, detect_every=sample_detect_every)
                if not res["inference"]:
                    print("WARNING: warmup sample_upload produced no "
                          "inference items (no face detected / not "
                          "decodable) — auxiliary request-path graphs were "
                          "NOT warmed; use a clip with a detectable face",
                          flush=True)
                phase("end-to-end sample request (what the enumerated "
                      "phases miss)")
        finally:
            made = _restore_counters(counters, saved)
            self.last_timings = timings
        for name, seconds in phases:
            print(f"warmup {seconds:7.1f}s  {name}", flush=True)
        total = time.perf_counter() - t_start
        print(f"engine warmup complete in {total:.1f}s", flush=True)
        self.last_warmup = {"seconds": total, "phases": phases,
                            "launches": made, "builds": _build.builds - builds0}

    def predict_chunks(self, chunks_u8: np.ndarray,
                       waveform: Optional[np.ndarray],
                       top_k: int = 3) -> Dict:
        """One clip: chunks (T, F, H, W, 3) uint8 (or float32 in [0, 1]) +
        16 kHz waveform (or None) → ``{"predicted_label",
        "predicted_index", "scores": top-k, "probabilities": all classes}``."""
        video_feats = self.video_extractor.embed_chunks(chunks_u8)   # (T, 768)
        if waveform is not None and len(waveform):
            audio_emb = self.audio_embedder.embed_batch([waveform])[0]
        else:
            audio_emb = np.zeros(self.model_cfg.audio_dim, np.float32)

        max_tokens = self.model_cfg.max_seq_len - 1
        t = video_feats.shape[0]
        if t > max_tokens:
            video_feats = video_feats[:max_tokens]
            mask = np.zeros((1, max_tokens), bool)
        else:
            pad = np.zeros((max_tokens - t, video_feats.shape[1]), np.float32)
            video_feats = np.concatenate([video_feats, pad])
            mask = np.arange(max_tokens)[None, :] >= t

        video_b, audio_b = self._normalize(video_feats[None], audio_emb[None])
        probs = self._fusion_probs(video_b, audio_b, mask)[0]
        order = np.argsort(-probs)[:top_k]
        return {
            "predicted_label": self.labels[int(order[0])],
            "predicted_index": int(order[0]),
            "scores": [{"label": self.labels[int(i)],
                        "probability": float(probs[i])} for i in order],
            "probabilities": [float(p) for p in probs],
        }

    def predict_clip(self, video_path: str, subchunk_size: int = 32,
                     top_k: int = 3) -> Optional[Dict]:
        """Whole-clip (non-windowed) prediction, the reference's legacy
        ``predict_from_file`` contract (back-end/app/inference.py:27-163):
        ``{"predicted_label", "predicted_index", "scores": top-k}``, or None
        when the container does not decode."""
        from mmer_tpu_torch.preprocess.audio import extract_audio_track
        from mmer_tpu_torch.preprocess.video import load_video_chunks

        chunks = load_video_chunks(video_path, subchunk_size,
                                   tuple(self.vivit_cfg.image_size))
        if chunks is None:
            return None
        waveform = extract_audio_track(video_path, self.wav_cfg.sample_rate)
        res = self.predict_chunks(chunks, waveform, top_k)
        del res["probabilities"]
        return res

    def infer_sequence(self, sub_chunks_u8: np.ndarray,
                       seq_frames_idx: Sequence[int],
                       waveform: Optional[np.ndarray], fps: float,
                       window_size: int = 5) -> Dict:
        """One face sequence: subchunks (n_sub, subchunk_size, H, W, 3)
        uint8, the original frame number of each of its frames, the clip's
        16 kHz waveform (or None) and its frame rate → one item per sliding
        window, ``{"inference": [{"class", "frame"}, ...],
        "probabilities": (n_sub, classes) list}``."""
        window_size = self._clamp_window(window_size)
        sub_feats = self.video_extractor.embed_chunks(sub_chunks_u8)
        timings = {k: 0.0 for k in STAGES}
        items, probs = self._windows(sub_feats, seq_frames_idx, waveform, fps,
                                     sub_chunks_u8.shape[1], window_size,
                                     False, timings)
        return {"inference": items, "probabilities": probs.tolist()}
