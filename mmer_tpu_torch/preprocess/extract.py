"""Offline feature extraction, the port of ``mmer_tpu/preprocess/extract.py``:
videos → (T, 768) npy, audio → (1024,) npy.

- Chunks from many videos are packed into fixed-size device batches and
  scattered back per video afterwards.
- Host decode runs in a thread pool that prefetches ahead of the device.
- ViViT params are the JAX package's seeded init for ``param_seed``, drawn
  without JAX (``models/jax_init.py``), so the port's features are the JAX
  package's; ``--params`` names a file (flax ``.msgpack``, readable and
  writable by both packages, or ``.npz``) that is read if it exists and
  written on first use.

CLI (runs on the GPU; ``--device cpu`` must be asked for):

    python -m mmer_tpu_torch.preprocess.extract video --input DIR --output DIR
    python -m mmer_tpu_torch.preprocess.extract audio --input DIR --output DIR

The serving path's crop stage lives here too: :class:`SubchunkStream` crops
raw frames on the device and embeds the uint8 subchunks without a trip back
to the host (``VideoFeatureExtractor.embed_cropped_frames`` is its one-shot
form).  ``extract_dataset_arrays`` waits for the trainer's raw-media route.

Over a mesh (``VideoFeatureExtractor(mesh=)``, the ``video`` subcommand's
``--mesh`` under ``torchrun``) every rank embeds its rows of each device
batch on its own device and one all-gather a batch assembles the features;
every rank decodes the folder, and rank 0 alone writes the artifacts.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import os
import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmer_tpu_torch.config import MeshConfig, ViViTConfig, Wav2Vec2Config
from mmer_tpu_torch.core.artifacts import (save_audio_features,
                                           save_video_features)
from mmer_tpu_torch.core.mesh import (Mesh, active_mesh, create_mesh,
                                      init_from_env, is_writer,
                                      pad_to_multiple)
from mmer_tpu_torch.models.convert import vivit_from_flax, vivit_to_flax
from mmer_tpu_torch.models.layers import load_or_save_params
from mmer_tpu_torch.models.vivit import ViViTFeatureExtractor, init_vivit
from mmer_tpu_torch.models.wav2vec2 import AudioEmbedder
from mmer_tpu_torch.preprocess.audio import (audio_output_name, iter_audio_files,
                                             load_waveform)
from mmer_tpu_torch.preprocess.video import (feature_output_name,
                                             iter_video_files, load_video_chunks)


def _require(device: torch.device | str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("extract: CUDA device requested but "
                           "torch.cuda.is_available() is False (pass "
                           "--device cpu to run on the CPU)")
    return device


class VideoFeatureExtractor:
    """Batched ViViT chunk embedder on one device, or over a mesh's data
    axis.

    ``params``: a state dict for the ViViT; else ``params_path`` (a flax
    ``.msgpack`` in the JAX layout, or an ``.npz`` state dict) is loaded if
    it exists and written with the seeded weights if not; else the weights
    are the JAX package's seeded init for ``cfg.param_seed``
    (:func:`~mmer_tpu_torch.models.vivit.init_vivit`).

    ``mesh`` (``core/mesh.py``, every rank constructing the extractor
    alike): ``device_batch`` is the global batch, rounded up to a multiple
    of the data axis; each rank embeds its rows of a batch on ``device`` and
    one all-gather over the data axis gives every rank the batch's features
    (JAX ``preprocess/extract.py:81-95``).
    """

    def __init__(self, cfg: Optional[ViViTConfig] = None, *,
                 device: torch.device | str, device_batch: int = 8,
                 params: Optional[dict] = None,
                 params_path: Optional[str] = None, use_kernels: bool = True,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg or ViViTConfig()
        self.device = torch.device(device)
        self.mesh = active_mesh(mesh, self.device)
        self.device_batch = (device_batch if self.mesh is None else
                             pad_to_multiple(device_batch, self.mesh.dp))
        kw = dict(device=self.device, use_kernels=use_kernels)
        self.model = load_or_save_params(
            lambda: ViViTFeatureExtractor(self.cfg, **kw),
            lambda: init_vivit(self.cfg, **kw), params, params_path,
            from_flax=vivit_from_flax, to_flax=vivit_to_flax)

    @torch.inference_mode()
    def embed_chunks(self, chunks, pipeline: bool = False) -> np.ndarray:
        """(N, F, H, W, C) raw uint8 or float32 in [0, 1] → (N, dim) float32.

        ``chunks`` is a host array or a tensor; a tensor already on the
        device is used where it lies (the crops of :class:`SubchunkStream`).
        Chunks go to the device in blocks of ``device_batch`` (the last
        block padded by repeating its final chunk, whose rows are dropped);
        uint8 frames are scaled by 1/255 on the device.

        ``pipeline=True`` double-buffers multi-block calls: block i+1 is
        staged on the host and its copy and forward are enqueued before
        block i's result is fetched, with at most two input blocks on the
        device.  On CUDA the blocks are staged in two pinned host buffers
        and copied with ``non_blocking``, and each result comes back through
        a pinned buffer guarded by an event, so the host's staging of block
        i+1 overlaps the device's work on block i.  The output is
        bit-identical to ``pipeline=False``; the default stays off as in the
        JAX extractor.

        Over a mesh each rank stages and embeds its rows of every block,
        and one all-gather a block returns the block's rows to every rank.
        """
        x_all = torch.as_tensor(chunks)
        n = x_all.shape[0]
        bs = self.device_batch
        rows = slice(None) if self.mesh is None else self.mesh.batch_rows(bs)
        # Host blocks are staged through pinned buffers on the card; blocks
        # that are on the device already need no staging.
        on_card = self.device.type == "cuda"
        staged = on_card and x_all.device.type == "cpu"
        staging: List[torch.Tensor] = []
        out: List[np.ndarray] = []
        in_flight = None        # (host tensor, event or None) of block i-1

        def fetch(host, event) -> np.ndarray:
            if event is not None:
                event.synchronize()
            return host.numpy()

        for i, start in enumerate(range(0, n, bs)):
            block = x_all[start:start + bs]
            if block.shape[0] < bs:
                block = torch.cat(
                    [block, block[-1:].expand(bs - block.shape[0],
                                              *block.shape[1:])])
            block = block[rows]
            if pipeline and staged:
                if len(staging) < 2:
                    staging.append(torch.empty(block.shape, dtype=block.dtype,
                                               pin_memory=True))
                # Slot i % 2 last held block i-2, whose result has been
                # fetched: its copy to the device is complete.
                staging[i % 2].copy_(block)
                x = staging[i % 2].to(self.device, non_blocking=True)
            else:
                x = block.to(self.device)
            if x.dtype == torch.uint8:
                x = x.float() / 255.0
            feats = self.model(x)
            if self.mesh is not None:
                feats = self.mesh.all_gather_rows(feats)
            if not pipeline:
                out.append(feats.cpu().numpy())
                continue
            if on_card:
                host = torch.empty(feats.shape, dtype=feats.dtype,
                                   pin_memory=True)
                host.copy_(feats, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                host, event = feats, None
            if in_flight is not None:
                out.append(fetch(*in_flight))
            in_flight = (host, event)
        if in_flight is not None:
            out.append(fetch(*in_flight))
        return np.concatenate(out)[:n]

    def embed_cropped_frames(self, frames_u8: np.ndarray, bboxes: np.ndarray,
                             subchunk_size: int) -> np.ndarray:
        """Serving's crop stage in one call: raw uint8 frames (N, H, W, C)
        and per-frame bboxes (N, 4) → (ceil(N / subchunk_size), dim)
        subchunk features.  Crop, resize, subchunk packing (the last
        subchunk padded by repeating its final frame and bbox) and the ViViT
        forward all run on the device; only the frames go up and only the
        feature rows come back.  Implemented over :class:`SubchunkStream`,
        the path the engine streams uploads through."""
        stream = SubchunkStream(self, subchunk_size)
        stream.add(frames_u8, bboxes)
        return stream.finish()


class SubchunkStream:
    """Incremental frames → subchunk features with bounded buffers.

    Holds at most ``subchunk_size`` raw frames on the host and up to
    ``extractor.device_batch`` cropped uint8 subchunks on the device: each
    full block of frames is cropped and resized on the device at once, and
    each ``device_batch`` group of cropped subchunks goes through
    ``embed_chunks`` as one device tensor.  The grouping is the one-shot
    :meth:`VideoFeatureExtractor.embed_cropped_frames` grouping, so streamed
    features equal it exactly.
    """

    def __init__(self, extractor: VideoFeatureExtractor, subchunk_size: int):
        self._ex = extractor
        self._sub = subchunk_size
        self._frames: List[np.ndarray] = []     # < subchunk_size raw frames
        self._bboxes: List[np.ndarray] = []
        self._crops: List[torch.Tensor] = []    # device uint8 subchunks
        self._feats: List[np.ndarray] = []
        self._last: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def add(self, frames_u8: np.ndarray, bboxes: np.ndarray) -> None:
        """Append (n, H, W, C) uint8 frames with (n, 4) float bboxes."""
        for i in range(frames_u8.shape[0]):
            self._frames.append(frames_u8[i])
            self._bboxes.append(np.asarray(bboxes[i], np.float32))
            if len(self._frames) == self._sub:
                self._crop_block()
        if frames_u8.shape[0]:
            self._last = (frames_u8[-1], np.asarray(bboxes[-1], np.float32))

    def _crop_block(self) -> None:
        from mmer_tpu_torch.ops.image import crop_resize_batch

        dev = self._ex.device
        crops = crop_resize_batch(
            torch.from_numpy(np.stack(self._frames)).to(dev),
            torch.from_numpy(np.stack(self._bboxes)).to(dev),
            out_hw=tuple(self._ex.cfg.image_size))
        # Truncating uint8 quantisation, as the JAX stream's astype.
        self._crops.append(torch.clamp(crops, 0, 255).to(torch.uint8))
        self._frames.clear()
        self._bboxes.clear()
        if len(self._crops) == self._ex.device_batch:
            self._flush_crops()

    def _flush_crops(self) -> None:
        if self._crops:
            self._feats.append(self._ex.embed_chunks(torch.stack(self._crops)))
            self._crops.clear()

    def finish(self) -> np.ndarray:
        """Pad and flush the remainder → (n_subchunks, dim) float32."""
        if self._frames and self._last is not None:
            frame, bbox = self._last
            while len(self._frames) < self._sub:
                self._frames.append(frame)
                self._bboxes.append(bbox)
            self._crop_block()
        self._flush_crops()
        if not self._feats:
            return np.zeros((0, self._ex.cfg.dim), np.float32)
        return np.concatenate(self._feats)


def iter_video_features(input_dir: str, extractor: VideoFeatureExtractor,
                        chunk_size: Optional[int] = None,
                        decode_workers: int = 4, verbose: bool = True):
    """Yield ``(path, (num_chunks, dim) features)`` for every decodable
    video under ``input_dir``: decode runs in a thread pool pipelined ahead
    of the device, and chunks from several videos are batched into each
    ``embed_chunks`` call."""
    chunk_size = chunk_size or extractor.cfg.num_frames
    paths = list(iter_video_files(input_dir))
    size = tuple(extractor.cfg.image_size)
    with cf.ThreadPoolExecutor(max_workers=decode_workers) as pool:
        # Bounded prefetch: Executor.map would submit every decode up front
        # and buffer the whole dataset's uint8 chunks in host memory if the
        # device lags; keep only ~2x workers in flight.
        path_iter = iter(paths)
        futures: deque = deque()

        def submit_next():
            p = next(path_iter, None)
            if p is not None:
                futures.append((p, pool.submit(
                    load_video_chunks, p, chunk_size, size, "uint8")))

        for _ in range(decode_workers * 2):
            submit_next()

        def decoded_iter():
            while futures:
                path, fut = futures.popleft()
                chunks = fut.result()
                submit_next()
                yield path, chunks

        pending: List[Tuple[str, int]] = []   # (path, num_chunks)
        buffer: List[np.ndarray] = []

        def flush():
            if not pending:
                return []
            feats = extractor.embed_chunks(np.concatenate(buffer, axis=0))
            items, offset = [], 0
            for path, n_chunks in pending:
                items.append((path, feats[offset:offset + n_chunks]))
                offset += n_chunks
            pending.clear()
            buffer.clear()
            return items

        budget = max(extractor.device_batch * 4, 32)
        done = 0
        for path, chunks in decoded_iter():
            if chunks is None:
                if verbose:
                    print(f"Failed to load video: {path}", flush=True)
                continue
            pending.append((path, chunks.shape[0]))
            buffer.append(chunks)
            if sum(c.shape[0] for c in buffer) >= budget:
                for item in flush():
                    done += 1
                    if verbose:
                        print(f"[{done}/{len(paths)}] {item[0]}", flush=True)
                    yield item
        for item in flush():
            done += 1
            if verbose:
                print(f"[{done}/{len(paths)}] {item[0]}", flush=True)
            yield item


def iter_audio_embeddings(input_dir: str, embedder: AudioEmbedder,
                          batch_size: int = 64, verbose: bool = True):
    """Yield ``(path, (hidden_dim,) embedding)`` for every decodable audio
    file under ``input_dir``, embedded in device batches of ``batch_size``."""
    batch: List[Tuple[str, np.ndarray]] = []

    def flush():
        if not batch:
            return []
        embs = embedder.embed_batch([w for _, w in batch])
        items = [(p, e) for (p, _), e in zip(batch, embs)]
        batch.clear()
        return items

    for path in iter_audio_files(input_dir):
        wave = load_waveform(path, embedder.cfg.sample_rate)
        if wave is None:
            if verbose:
                print(f"Failed to load audio: {path}", flush=True)
            continue
        batch.append((path, wave))
        if len(batch) >= batch_size:
            yield from flush()
    yield from flush()


def extract_video_folder(input_dir: str, output_dir: str,
                         extractor: Optional[VideoFeatureExtractor] = None,
                         chunk_size: Optional[int] = None,
                         decode_workers: int = 4, verbose: bool = True, *,
                         device: torch.device | str = "cuda") -> int:
    """Walk ``input_dir``, write one ``(num_chunks, 768)`` npy per video to
    ``output_dir`` with the reference's artifact naming; returns the count.
    ``device`` is where a default extractor is built.  Over a mesh only rank
    0 writes and reports."""
    extractor = extractor or VideoFeatureExtractor(device=_require(device))
    verbose = verbose and is_writer()
    count = 0
    t0 = time.time()
    for path, feats in iter_video_features(input_dir, extractor, chunk_size,
                                           decode_workers, verbose):
        out_name = feature_output_name(path, input_dir)
        if is_writer():
            save_video_features(os.path.join(output_dir, out_name), feats)
        count += 1
        if verbose:
            print(f"[{count}] {out_name}", flush=True)
    if verbose:
        dt = time.time() - t0
        print(f"Finished: {count} videos in {dt:.1f}s "
              f"({count / max(dt, 1e-9):.2f} clips/s)", flush=True)
    return count


def extract_audio_folder(input_dir: str, output_dir: str,
                         cfg: Optional[Wav2Vec2Config] = None,
                         batch_size: int = 64, verbose: bool = True, *,
                         device: torch.device | str = "cuda",
                         embedder: Optional[AudioEmbedder] = None) -> int:
    """Audio twin of :func:`extract_video_folder`: decode → 16 kHz mono →
    Wav2Vec2 embed → L2-normalised (1024,) float16 npy with the
    dataset-specific renaming of ``audio_output_name``; returns the count.
    Embeddings do not depend on the batch size (length-masked pooling).
    ``embedder`` replaces the default one built from ``cfg`` on ``device``
    (the JAX package's seeded weights for ``cfg.param_seed``)."""
    embedder = embedder or AudioEmbedder(cfg or Wav2Vec2Config(),
                                         device=_require(device))
    count = 0
    for path, emb in iter_audio_embeddings(input_dir, embedder, batch_size,
                                           verbose):
        name = audio_output_name(os.path.basename(path))
        if is_writer():
            save_audio_features(os.path.join(output_dir, name), emb)
        count += 1
        if verbose:
            print(f"[{count}] {name}", flush=True)
    if verbose:
        print(f"Finished: {count} audio files.", flush=True)
    return count


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="Offline feature extraction (video → ViViT, audio → Wav2Vec2)")
    sub = parser.add_subparsers(dest="modality", required=True)

    pv = sub.add_parser("video", help="extract (T, 768) video features")
    pv.add_argument("--input", required=True)
    pv.add_argument("--output", required=True)
    pv.add_argument("--chunk_size", type=int, default=32)
    pv.add_argument("--device_batch", type=int, default=8)
    pv.add_argument("--params", default=None,
                    help="ViViT params file: a flax .msgpack in the JAX "
                         "package's layout (its extractor's params file) or "
                         "an .npz state dict; read if it exists, else written "
                         "with the seeded weights")
    pv.add_argument("--mesh", action="store_true",
                    help="shard chunk batches over the ranks of the world "
                         "torchrun launched (dp mesh)")

    pa = sub.add_parser("audio", help="extract (1024,) audio embeddings")
    pa.add_argument("--input", required=True)
    pa.add_argument("--output", required=True)
    pa.add_argument("--batch_size", type=int, default=8)

    for p in (pv, pa):
        p.add_argument("--device", default="cuda",
                       help="torch device; fails if it is cuda and no GPU is "
                            "present (default: cuda)")

    args = parser.parse_args(argv)
    device = _require(args.device)
    if args.modality == "video":
        mesh = None
        if args.mesh:
            device = init_from_env(device)
            mesh = create_mesh(MeshConfig())
        extractor = VideoFeatureExtractor(device=device,
                                          device_batch=args.device_batch,
                                          params_path=args.params, mesh=mesh)
        extract_video_folder(args.input, args.output, extractor,
                             chunk_size=args.chunk_size)
    else:
        extract_audio_folder(args.input, args.output,
                             batch_size=args.batch_size, device=device)


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
