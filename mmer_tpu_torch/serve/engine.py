"""Clip → emotion probabilities, the port of ``mmer_tpu/serve/engine.py``.

Two array-level entry points, both starting from decoded data:

- :meth:`InferenceEngine.predict_chunks` — the body of the JAX engine's
  ``predict_clip`` after decoding: all chunks of a clip → (T, 768), the
  whole waveform → (1024,), the fusion model over up to ``max_seq_len − 1``
  video slots;
- :meth:`InferenceEngine.infer_sequence` — the window stage of
  ``infer_video_file`` for one face sequence: per-subchunk ViViT features
  computed once, one audio slice per sliding window embedded in one batch,
  windows batched through the fusion model grouped by token count.

On a CUDA device the extractors always run the hand-written kernels.
Decoding, face detection, cropping and explanations come with the serving
slice.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmer_tpu_torch.config import LABELS, ModelConfig, ViViTConfig, Wav2Vec2Config
from mmer_tpu_torch.core.buckets import batch_bucket


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


class InferenceEngine:
    """Lazily built extractors and fusion model on one device.

    ``device`` is required: ``"cuda"`` raises when CUDA is unavailable.
    ``fusion_params_path`` is a ``.pth`` state dict of the port's
    :class:`~mmer_tpu_torch.models.fusion.MultimodalEmotionModel`; without
    it the fusion weights are seeded from 0, as the JAX engine's are.
    """

    def __init__(self, device: torch.device | str, *,
                 model_cfg: Optional[ModelConfig] = None,
                 vivit_cfg: Optional[ViViTConfig] = None,
                 wav_cfg: Optional[Wav2Vec2Config] = None,
                 fusion_params_path: Optional[str] = None,
                 vivit_params_path: Optional[str] = None,
                 wav_params_path: Optional[str] = None,
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
        self._video_extractor = None
        self._audio_embedder = None
        self._fusion = None

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
    def fusion(self):
        """The fusion model: loaded from ``fusion_params_path`` (shape
        mismatches raise) or seeded."""
        if self._fusion is None:
            from mmer_tpu_torch.models.fusion import init_fusion
            from mmer_tpu_torch.models.layers import param_generator

            model = init_fusion(self.model_cfg, device=self.device,
                                generator=param_generator(0, self.device))
            if self.fusion_params_path:
                if not os.path.exists(self.fusion_params_path):
                    raise FileNotFoundError(
                        f"fusion checkpoint not found: {self.fusion_params_path}")
                model.load_state_dict(torch.load(
                    self.fusion_params_path, map_location=self.device,
                    weights_only=True))
            self._fusion = model
        return self._fusion

    def _normalize(self, video_feats: np.ndarray, audio_feats: np.ndarray):
        """Apply training-time global z-score stats when available."""
        vm, vs = self.norm_stats.get("video_mean"), self.norm_stats.get("video_std")
        am, as_ = self.norm_stats.get("audio_mean"), self.norm_stats.get("audio_std")
        if vm is not None:
            video_feats = (video_feats - vm) / vs
        if am is not None:
            audio_feats = (audio_feats - am) / as_
        return video_feats, audio_feats

    @torch.inference_mode()
    def _fusion_probs(self, video: np.ndarray, audio: np.ndarray,
                      mask: np.ndarray) -> np.ndarray:
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        probs, _, _ = self.fusion(dev(video.astype(np.float32)),
                                  dev(audio.astype(np.float32)), dev(mask))
        return probs.cpu().numpy()

    def predict_chunks(self, chunks_u8: np.ndarray,
                       waveform: Optional[np.ndarray],
                       top_k: int = 3) -> Dict:
        """One clip: chunks (T, F, H, W, 3) uint8 + 16 kHz waveform (or
        None) → ``{"predicted_label", "predicted_index", "scores": top-k,
        "probabilities": all classes}``."""
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

    def infer_sequence(self, sub_chunks_u8: np.ndarray,
                       seq_frames_idx: Sequence[int],
                       waveform: Optional[np.ndarray], fps: float,
                       window_size: int = 5) -> Dict:
        """One face sequence: subchunks (n_sub, subchunk_size, H, W, 3)
        uint8, the original frame number of each of its frames, the clip's
        16 kHz waveform (or None) and its frame rate → one item per sliding
        window, ``{"inference": [{"class", "frame"}, ...],
        "probabilities": (n_sub, classes) list}``."""
        subchunk_size = sub_chunks_u8.shape[1]
        max_tokens = self.model_cfg.max_seq_len - 1
        if window_size > max_tokens:
            print(f"window_size {window_size} exceeds the fusion model's "
                  f"{max_tokens} video slots; clamping", flush=True)
            window_size = max_tokens

        sub_feats = self.video_extractor.embed_chunks(sub_chunks_u8)
        n_sub = sub_feats.shape[0]
        win_lens = [min(window_size, n_sub - s) for s in range(n_sub)]

        # Per-window audio slices, embedded in one batch.
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

        # Windows batched by token count, batch sizes bucketed; padding rows
        # repeat the last window and are dropped.
        by_len: Dict[int, List[int]] = {}
        for s, wl in enumerate(win_lens):
            by_len.setdefault(wl, []).append(s)
        probs_all = np.zeros((n_sub, len(self.labels)), np.float32)
        for wl, starts in by_len.items():
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
            probs_all[starts] = self._fusion_probs(video_w, audio_w, mask)[:nb]

        inference = []
        for s in range(n_sub):
            first = s * subchunk_size
            frame = seq_frames_idx[first] if first < len(seq_frames_idx) else 0
            inference.append({"class": self.labels[int(np.argmax(probs_all[s]))],
                              "frame": int(frame)})
        return {"inference": inference, "probabilities": probs_all.tolist()}
