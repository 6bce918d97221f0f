"""cv2-based preview transcode for FLVs the copy-remux cannot handle.

Copied from ``mmer_tpu/serve/transcode.py``: the port imports nothing of the
JAX package, and ``tests/test_torch_media.py`` holds this copy to the
original on the original's test inputs.

The reference converts FLV uploads in the BROWSER with ffmpeg.wasm, in a
three-step fallback chain — stream copy, then libx264, then mpeg4
(reference front-end/src/components/VideoPlayer.tsx:336-360) — plus an
flv.js streaming fallback (:478-544).  This build does the equivalent
server-side with no wasm download: ``serve/remux.py`` is the stream-copy
step (H.264 + AAC/MP3 → byte copy), and this module is the transcode
step for everything else (Sorenson H.263 / FLV1, VP6, …): decode with
OpenCV's bundled FFmpeg, re-encode as MPEG-4 Part 2 (``mp4v`` — the same
codec as the reference's last-resort ``-c:v mpeg4``), and, when the FLV
carries a copyable AAC/MP3 audio track next to the un-copyable video,
extract the transcoded MP4's video track and re-mux it TOGETHER with the
byte-copied audio so the preview keeps sound.

Preview-quality by design: inference always runs on the ORIGINAL upload
(serve/engine.py); this path only feeds the browser ``<video>`` element.
Frames stream through cv2 one at a time — host memory stays bounded by
one frame regardless of upload length.
"""

from __future__ import annotations

import os
import struct
import tempfile
from typing import List, Optional, Tuple

from mmer_tpu_torch.serve.remux import (RemuxError, _box, _build_audio_trak,
                                  _full, _trak, flv_to_mp4, parse_flv)

__all__ = ["flv_preview_mp4", "transcode_video_mp4"]


def transcode_video_mp4(data: bytes, suffix: str = ".flv") -> bytes:
    """Decode any cv2-readable video and re-encode as an ``mp4v`` MP4
    (video only).  Raises :class:`RemuxError` when cv2 cannot decode."""
    import cv2

    with tempfile.TemporaryDirectory(prefix="mmer_transcode_") as tmp:
        src = os.path.join(tmp, "in" + suffix)
        dst = os.path.join(tmp, "out.mp4")
        with open(src, "wb") as f:
            f.write(data)
        cap = cv2.VideoCapture(src)
        try:
            if not cap.isOpened():
                raise RemuxError("cv2 cannot open the upload for "
                                 "preview transcode")
            fps = cap.get(cv2.CAP_PROP_FPS)
            if not fps or fps != fps or fps <= 0 or fps > 240:
                fps = 25.0                # FLV metadata often lies
            writer = None
            frames = 0
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                if writer is None:
                    h, w = frame.shape[:2]
                    writer = cv2.VideoWriter(
                        dst, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
                    if not writer.isOpened():
                        raise RemuxError("cv2 mp4v encoder unavailable")
                writer.write(frame)
                frames += 1
            if writer is not None:
                writer.release()
        finally:
            cap.release()
        if frames == 0:
            raise RemuxError("cv2 decoded no frames from the upload")
        with open(dst, "rb") as f:
            return f.read()


# --------------------------------------------------------------------------
# Minimal MP4 demux: pull the video track back out of cv2's MP4 so it can
# be re-muxed next to the byte-copied FLV audio track.
# --------------------------------------------------------------------------

def _iter_boxes(data: bytes, start: int = 0, end: Optional[int] = None):
    off, end = start, len(data) if end is None else end
    while off + 8 <= end:
        size = struct.unpack(">I", data[off:off + 4])[0]
        typ = data[off + 4:off + 8]
        if size == 1:                     # 64-bit largesize
            size = struct.unpack(">Q", data[off + 8:off + 16])[0]
            yield typ, off + 16, off + size
        elif size == 0:                   # box extends to end of file
            yield typ, off + 8, end
            size = end - off
        else:
            yield typ, off + 8, off + size
        if size < 8:
            raise RemuxError("corrupt MP4 from transcoder (bad box size)")
        off += size


def _find(data: bytes, path: List[bytes], start: int = 0,
          end: Optional[int] = None) -> Tuple[int, int]:
    """(payload_start, payload_end) of the first box at ``path``."""
    for typ, s, e in _iter_boxes(data, start, end):
        if typ == path[0]:
            if len(path) == 1:
                return s, e
            return _find(data, path[1:], s, e)
    raise RemuxError(f"transcoded MP4 lacks a {b'/'.join(path).decode()} box")


def _u32_table(data: bytes, s: int, e: int) -> List[int]:
    count = struct.unpack(">I", data[s + 4:s + 8])[0]
    return list(struct.unpack(f">{count}I", data[s + 8:s + 8 + 4 * count]))


def _extract_video_track(mp4: bytes):
    """(stsd_entry, timescale, deltas, keyframes_or_None, samples) of the
    first video trak.  ``samples`` is the list of raw sample payloads in
    sample order; chunk layout is resolved through stsc/stco."""
    moov_s, moov_e = _find(mp4, [b"moov"])
    for typ, ts_, te_ in _iter_boxes(mp4, moov_s, moov_e):
        if typ != b"trak":
            continue
        hdlr_s, hdlr_e = _find(mp4, [b"mdia", b"hdlr"], ts_, te_)
        if mp4[hdlr_s + 8:hdlr_s + 12] != b"vide":
            continue
        mdhd_s, _ = _find(mp4, [b"mdia", b"mdhd"], ts_, te_)
        ts_off = mdhd_s + (20 if mp4[mdhd_s] == 1 else 12)
        timescale = struct.unpack(">I", mp4[ts_off:ts_off + 4])[0]
        stbl_s, stbl_e = _find(mp4, [b"mdia", b"minf", b"stbl"], ts_, te_)
        boxes = {typ2: (s2, e2)
                 for typ2, s2, e2 in _iter_boxes(mp4, stbl_s, stbl_e)}

        s, e = boxes[b"stsd"]
        entry_size = struct.unpack(">I", mp4[s + 8:s + 12])[0]
        stsd_entry = mp4[s + 8:s + 8 + entry_size]

        s, e = boxes[b"stts"]
        n_runs = struct.unpack(">I", mp4[s + 4:s + 8])[0]
        deltas: List[int] = []
        for i in range(n_runs):
            cnt, delta = struct.unpack(">II", mp4[s + 8 + 8 * i:
                                                  s + 16 + 8 * i])
            deltas.extend([delta] * cnt)

        s, e = boxes[b"stsz"]
        fixed = struct.unpack(">I", mp4[s + 4:s + 8])[0]
        count = struct.unpack(">I", mp4[s + 8:s + 12])[0]
        sizes = ([fixed] * count if fixed else
                 list(struct.unpack(f">{count}I",
                                    mp4[s + 12:s + 12 + 4 * count])))

        if b"stco" in boxes:
            s, e = boxes[b"stco"]
            chunk_offs = _u32_table(mp4, s, e)
        else:                             # co64
            s, e = boxes[b"co64"]
            cnt = struct.unpack(">I", mp4[s + 4:s + 8])[0]
            chunk_offs = list(struct.unpack(f">{cnt}Q",
                                            mp4[s + 8:s + 8 + 8 * cnt]))

        s, e = boxes[b"stsc"]
        n_ent = struct.unpack(">I", mp4[s + 4:s + 8])[0]
        stsc = [struct.unpack(">III", mp4[s + 8 + 12 * i:s + 20 + 12 * i])
                for i in range(n_ent)]    # (first_chunk, per_chunk, desc)

        keyframes: Optional[List[int]] = None
        if b"stss" in boxes:
            s, e = boxes[b"stss"]
            keyframes = _u32_table(mp4, s, e)

        # Resolve per-sample offsets through the chunk map.
        samples: List[bytes] = []
        si = 0
        for ci, chunk_off in enumerate(chunk_offs):
            per_chunk = 0
            for first, per, _ in stsc:
                if ci + 1 >= first:
                    per_chunk = per
            off = chunk_off
            for _ in range(per_chunk):
                if si >= len(sizes):
                    break
                samples.append(mp4[off:off + sizes[si]])
                off += sizes[si]
                si += 1
        if si != len(sizes):
            raise RemuxError("transcoded MP4 sample/chunk tables disagree")
        if len(deltas) < len(sizes):      # tolerate a short final stts run
            deltas.extend([deltas[-1] if deltas else 1]
                          * (len(sizes) - len(deltas)))
        return stsd_entry, timescale, deltas[:len(sizes)], keyframes, samples
    raise RemuxError("transcoded MP4 has no video track")


def _merge_audio(video_mp4: bytes, flv_streams) -> bytes:
    """New MP4 = transcoded video track + byte-copied FLV audio track,
    samples interleaved in decode order."""
    stsd_entry, timescale, deltas, keyframes, vsamples = \
        _extract_video_track(video_mp4)

    # Video DTS in ms for interleave ordering.  The cv2-transcoded track
    # restarts presentation at 0 from the FLV's FIRST VIDEO frame, so
    # audio timestamps are rebased onto that origin (an FLV captured
    # mid-stream starts at an arbitrary absolute ms — using it raw would
    # both misorder the interleave and delay audio by the absolute
    # start, remux.flv_to_mp4:589 does the same rebase).
    v0 = flv_streams.video[0][0] if flv_streams.video else 0
    vdts_ms: List[int] = []
    t = 0
    for d in deltas:
        vdts_ms.append(int(t * 1000 / timescale))
        t += d
    order: List[Tuple[int, int, int]] = [
        (dts, 0, i) for i, dts in enumerate(vdts_ms)]
    order += [(dts - v0, 1, i)
              for i, (dts, _) in enumerate(flv_streams.audio)]
    order.sort(key=lambda x: (x[0], x[1]))

    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 0x200),
                b"isomiso2mp41")
    base = len(ftyp) + 8
    total = base + sum(len(s) for s in vsamples) \
        + sum(len(s[1]) for s in flv_streams.audio)
    if total >= 1 << 32:
        raise RemuxError("merged preview would exceed 4 GiB (co64 needed)")
    mdat = bytearray()
    voffs = [0] * len(vsamples)
    aoffs = [0] * len(flv_streams.audio)
    for _, track, i in order:
        data = vsamples[i] if track == 0 else flv_streams.audio[i][1]
        (voffs if track == 0 else aoffs)[i] = base + len(mdat)
        mdat += data

    movie_ts = 1000
    vdur = sum(deltas)
    vdur_ms = int(vdur * 1000 / timescale)
    # Width/height live in the visual sample entry (bytes 24:28 of the
    # entry body after the 8-byte header + 6+2 reserved/dref prefix).
    width, height = struct.unpack(">HH", stsd_entry[8 + 24:8 + 28])
    vtrak = _trak(1, timescale, vdur, vdur_ms, b"vide",
                  b"mmer_tpu video transcode",
                  _full(b"vmhd", 0, 1, b"\x00" * 8), stsd_entry,
                  deltas, [len(s) for s in vsamples], voffs,
                  width=width, height=height, keyframes=keyframes)
    atrak, adur_ms = _build_audio_trak(
        flv_streams, 2, aoffs,
        max(flv_streams.audio[0][0] - v0, 0), movie_ts)

    from mmer_tpu_torch.serve.remux import _matrix
    mvhd = _full(b"mvhd", 0, 0,
                 struct.pack(">IIII", 0, 0, movie_ts,
                             max(vdur_ms, adur_ms)),
                 struct.pack(">IHH", 0x00010000, 0x0100, 0),
                 b"\x00" * 8, _matrix(), b"\x00" * 24,
                 struct.pack(">I", 3))
    moov = _box(b"moov", mvhd, vtrak, atrak)
    return ftyp + _box(b"mdat", bytes(mdat)) + moov


def flv_preview_mp4(data: bytes) -> Tuple[bytes, str]:
    """FLV upload → browser-playable MP4 by the cheapest route.

    Returns ``(mp4_bytes, mode)`` with mode ``"copy"`` (byte copy via
    :func:`remux.flv_to_mp4`) or ``"transcode"`` (cv2 mp4v re-encode,
    audio byte-copied alongside when it is AAC/MP3).  Raises
    :class:`RemuxError` when neither route works — the API's 415.
    """
    try:
        return flv_to_mp4(data), "copy"
    except RemuxError as copy_err:
        first_error = copy_err
    try:
        mp4 = transcode_video_mp4(data)
    except RemuxError as e:
        raise RemuxError(f"copy-remux failed ({first_error}); "
                         f"transcode failed ({e})")
    # Salvage a copyable audio track next to the transcoded video.
    try:
        streams = parse_flv(data, skip_unsupported=True)
        if streams.audio:
            mp4 = _merge_audio(mp4, streams)
    except (RemuxError, struct.error, IndexError, KeyError):
        pass                              # video-only preview still works
    return mp4, "transcode"
