"""Pure-Python PCM audio track mux/demux for MP4 containers.

Copied from ``mmer_tpu/serve/pcm_mp4.py``: the port imports nothing of the
JAX package, and ``tests/test_torch_media.py`` holds this copy to the
original on the original's test inputs.  One deliberate difference: ``_read_pcm``
reads no chunk past the end of the file, and a sample table that
claims more bytes than the file holds is refused (no PCM track).

The in-image decodable serving-audio route (VERDICT r4 #1): this image has
no ffmpeg, so the reference's request-path audio embedding (reference
back-end/app/libs/inference.py:413-469 runs Wav2Vec2 on per-window audio
slices of every upload) had no live input here — every upload took the
zero-audio fallback.  An MP4 that carries an UNCOMPRESSED PCM audio track
('sowt'/'twos' sample entries, QuickTime-lineage ISO 14496-12 audio)
decodes with ~10 lines of numpy, no codec work, so:

- :func:`mux_pcm_track` adds a 16-bit PCM track to any existing MP4
  (e.g. a cv2-written upload) by REPLACING its ``moov`` with a same-size
  ``free`` box (existing ``stco`` offsets stay valid — no payload bytes
  move) and appending a new ``mdat`` + a patched ``moov`` carrying the
  extra ``trak``.  Test/bench/demo uploads synthesized in-image carry
  real audio this way.
- :func:`demux_pcm_track` reads such a track back: box-walk ``moov``,
  find a ``soun`` trak whose sample entry is 'sowt' (LE) or 'twos' (BE),
  reconstruct sample bytes via stsc/stco/stsz, → float32 mono waveform.
  ``preprocess/audio.extract_audio_track`` tries this route BEFORE the
  ffmpeg CLI, which makes the serving audio leg live with zero external
  binaries.

Box layout follows ISO/IEC 14496-12; the mux reuses the box builders from
:mod:`mmer_tpu_torch.serve.remux` (the FLV→MP4 remuxer), with a constant-size
``stsz`` (one PCM frame per sample) so tables stay O(1) in audio length.
Reads are seek-based: probing a path touches only box headers + ``moov`` +
the audio chunks, never the video ``mdat`` — the long-upload bounded-memory
posture (VERDICT r2 #6) is preserved.
"""

from __future__ import annotations

import io
import os
import struct
from typing import BinaryIO, Dict, List, Optional, Tuple, Union

import numpy as np

from mmer_tpu_torch.serve.remux import _box, _full, _matrix

__all__ = ["mux_pcm_track", "mux_pcm_into_file", "demux_pcm_track",
           "MuxError"]

_PCM_FOURCC = {b"sowt": "<i2", b"twos": ">i2"}


class MuxError(ValueError):
    """Input is not an MP4 we can add / read a PCM track from."""


# --------------------------------------------------------------------------
# box walking (seek-based)
# --------------------------------------------------------------------------

def _iter_boxes(f: BinaryIO, start: int, end: int):
    """Yield (fourcc, header_size, box_start, box_end) for each child box
    of [start, end).  Handles 64-bit largesize and size==0 (to end)."""
    off = start
    while off + 8 <= end:
        f.seek(off)
        hdr = f.read(8)
        if len(hdr) < 8:
            return
        size = struct.unpack(">I", hdr[:4])[0]
        typ = hdr[4:8]
        hsize = 8
        if size == 1:
            big = f.read(8)
            if len(big) < 8:
                return
            size = struct.unpack(">Q", big)[0]
            hsize = 16
        elif size == 0:
            size = end - off
        if size < hsize:
            raise MuxError(f"corrupt box {typ!r} at {off}: size {size}")
        yield typ, hsize, off, min(off + size, end)
        off += size


def _child(f: BinaryIO, start: int, end: int, typ: bytes
           ) -> Optional[Tuple[int, int, int]]:
    """(header_size, box_start, box_end) of the first child of type
    ``typ``."""
    for t, hs, s, e in _iter_boxes(f, start, end):
        if t == typ:
            return hs, s, e
    return None


def _descend(f: BinaryIO, start: int, end: int, *path: bytes
             ) -> Optional[Tuple[int, int, int]]:
    cur = (8, start - 8, end)  # sentinel: body == [start, end)
    body = (start, end)
    for typ in path:
        found = _child(f, body[0], body[1], typ)
        if found is None:
            return None
        cur = found
        body = (found[1] + found[0], found[2])
    return cur


# --------------------------------------------------------------------------
# demux
# --------------------------------------------------------------------------

def _parse_stbl(f: BinaryIO, start: int, end: int) -> Optional[Dict]:
    """Sample-table fields needed to reconstruct a PCM stream."""
    stsd = _child(f, start, end, b"stsd")
    if stsd is None:
        return None
    hs, s, e = stsd
    f.seek(s + hs + 4)                     # skip fullbox version/flags
    (n_entries,) = struct.unpack(">I", f.read(4))
    if n_entries < 1:
        return None
    entry_hdr = f.read(8)
    fourcc = entry_hdr[4:8]
    if fourcc not in _PCM_FOURCC:
        return None
    # Audio sample entry v0 (ISO 14496-12 §12.2.3): 6 reserved +
    # data_ref_index(2) + version(2) + revision(2) + vendor(4) +
    # channels(2) + bits(2) + compression_id(2) + packet_size(2) +
    # rate(4, 16.16 fixed).
    body = f.read(28)
    if len(body) < 28:
        return None
    version = struct.unpack(">H", body[8:10])[0]
    channels, bits = struct.unpack(">HH", body[16:20])
    rate = struct.unpack(">I", body[24:28])[0] >> 16
    if bits != 16 or version != 0:
        return None                        # only the layout we mux

    def full_body(typ: bytes) -> Optional[bytes]:
        found = _child(f, start, end, typ)
        if found is None:
            return None
        hs_, s_, e_ = found
        f.seek(s_ + hs_ + 4)
        return f.read(e_ - (s_ + hs_ + 4))

    stsz_raw = full_body(b"stsz")
    stsc_raw = full_body(b"stsc")
    stco_raw = full_body(b"stco")
    co64 = False
    if stco_raw is None:
        stco_raw = full_body(b"co64")
        co64 = True
    if stsz_raw is None or stsc_raw is None or stco_raw is None:
        return None
    sample_size, n_samples = struct.unpack(">II", stsz_raw[:8])
    sizes = (None if sample_size else
             np.frombuffer(stsz_raw[8:8 + 4 * n_samples], ">u4"))
    (n_stsc,) = struct.unpack(">I", stsc_raw[:4])
    stsc = [struct.unpack(">III", stsc_raw[4 + 12 * i:16 + 12 * i])
            for i in range(n_stsc)]
    (n_chunks,) = struct.unpack(">I", stco_raw[:4])
    fmt = ">u8" if co64 else ">u4"
    offsets = np.frombuffer(stco_raw[4:4 + (8 if co64 else 4) * n_chunks],
                            fmt)
    return {"fourcc": fourcc, "channels": max(channels, 1), "rate": rate,
            "sample_size": sample_size, "n_samples": n_samples,
            "sizes": sizes, "stsc": stsc, "offsets": offsets}


def _read_pcm(f: BinaryIO, tbl: Dict, size: int) -> np.ndarray:
    """Gather the track's sample bytes via stsc/stco → int16 stream.

    ``size`` is the file's length: a chunk that the tables place or size
    past it raises :class:`MuxError` before anything is read, so a crafted
    ``stsz``/``stsc`` never turns into a huge ``read``."""
    chunks: List[bytes] = []
    stsc, offsets = tbl["stsc"], tbl["offsets"]
    remaining = tbl["n_samples"]
    sample_idx = 0
    for ci in range(len(offsets)):
        # samples-per-chunk of chunk ci+1 = last stsc entry whose
        # first_chunk <= ci+1
        spc = 1
        for first, count, _ in stsc:
            if first <= ci + 1:
                spc = count
        spc = min(spc, remaining)
        if spc <= 0:
            break
        if tbl["sample_size"]:
            nbytes = spc * tbl["sample_size"]
        else:
            nbytes = int(tbl["sizes"][sample_idx:sample_idx + spc].sum())
        offset = int(offsets[ci])
        if nbytes > size - offset:
            raise MuxError(f"PCM chunk {ci} claims {nbytes} bytes at offset "
                           f"{offset}, past the end of a {size}-byte file")
        f.seek(offset)
        chunks.append(f.read(nbytes))
        sample_idx += spc
        remaining -= spc
    return np.frombuffer(b"".join(chunks), _PCM_FOURCC[tbl["fourcc"]])


def demux_pcm_track(src: Union[str, bytes, os.PathLike]
                    ) -> Optional[Tuple[np.ndarray, int]]:
    """(float32 mono waveform, sample_rate) of the first PCM audio track
    in an MP4, or None when ``src`` is not an MP4 / has no such track.
    Accepts a path (seek-based reads — only box headers, ``moov``, and
    audio chunks are touched) or raw bytes."""
    if isinstance(src, (bytes, bytearray)):
        f: BinaryIO = io.BytesIO(src)
        size = len(src)
    else:
        try:
            size = os.path.getsize(src)
            f = open(src, "rb")
        except OSError:
            return None
    try:
        # The WHOLE parse is best-effort: this runs on every untrusted
        # /infer upload BEFORE the ffmpeg fallback, so any malformed box
        # interior (corrupt nested sizes → MuxError, short reads →
        # struct.error, misaligned tables → ValueError) must mean "no PCM
        # track here" (the zero-audio fallback), never a request-killing
        # exception (review r5 #1: a valid-ftyp file with a corrupt moov
        # child previously 500'd the request).
        boxes = list(_iter_boxes(f, 0, size))
        if not any(t == b"ftyp" for t, _, _, _ in boxes[:2]):
            return None
        moov = next(((hs, s, e) for t, hs, s, e in boxes if t == b"moov"),
                    None)
        if moov is None:
            return None
        hs, s, e = moov
        for t, ths, ts, te in _iter_boxes(f, s + hs, e):
            if t != b"trak":
                continue
            mdia = _descend(f, ts + ths, te, b"mdia")
            if mdia is None:
                continue
            mhs, ms, me = mdia
            hdlr = _child(f, ms + mhs, me, b"hdlr")
            if hdlr is None:
                continue
            f.seek(hdlr[1] + hdlr[0] + 8)
            if f.read(4) != b"soun":
                continue
            stbl = _descend(f, ms + mhs, me, b"minf", b"stbl")
            if stbl is None:
                continue
            tbl = _parse_stbl(f, stbl[1] + stbl[0], stbl[2])
            if tbl is None or not tbl["rate"]:
                continue
            pcm = _read_pcm(f, tbl, size)
            wav = pcm.astype(np.float32) / 32768.0
            ch = tbl["channels"]
            if ch > 1 and len(wav) % ch == 0:
                wav = wav.reshape(-1, ch).mean(axis=1)
            return wav, int(tbl["rate"])
        return None
    except (MuxError, struct.error, ValueError):
        return None
    finally:
        f.close()


# --------------------------------------------------------------------------
# mux
# --------------------------------------------------------------------------

def _pcm_trak(track_id: int, n: int, sample_rate: int, mvhd_dur: int,
              data_offset: int) -> bytes:
    """A 'sowt' (16-bit LE PCM, mono) audio trak: one chunk holding all
    ``n`` frames, constant 2-byte samples, timescale = sample rate."""
    tkhd = _full(b"tkhd", 0, 3,
                 struct.pack(">IIII", 0, 0, track_id, 0),
                 struct.pack(">I", mvhd_dur),
                 b"\x00" * 8,
                 struct.pack(">hhhh", 0, 0, 0x0100, 0),
                 _matrix(),
                 struct.pack(">II", 0, 0))
    mdhd = _full(b"mdhd", 0, 0,
                 struct.pack(">IIIIHH", 0, 0, sample_rate, n, 0x55C4, 0))
    hdlr = _full(b"hdlr", 0, 0, b"\x00" * 4, b"soun", b"\x00" * 12,
                 b"mmer_tpu pcm audio\x00")
    dinf = _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1),
                               _full(b"url ", 0, 1)))
    entry = (b"\x00" * 6 + struct.pack(">H", 1)       # data_ref_index
             + b"\x00" * 8                            # version/rev/vendor
             + struct.pack(">HH", 1, 16)              # mono, 16-bit
             + b"\x00" * 4                            # compression/packet
             + struct.pack(">I", sample_rate << 16))
    stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1), _box(b"sowt", entry))
    stts = _full(b"stts", 0, 0, struct.pack(">III", 1, n, 1))
    stsc = _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
    stsz = _full(b"stsz", 0, 0, struct.pack(">II", 2, n))
    stco = _full(b"stco", 0, 0, struct.pack(">II", 1, data_offset))
    stbl = _box(b"stbl", stsd, stts, stsc, stsz, stco)
    minf = _box(b"minf", _full(b"smhd", 0, 0, b"\x00" * 4), dinf, stbl)
    mdia = _box(b"mdia", mdhd, hdlr, minf)
    return _box(b"trak", tkhd, mdia)


def mux_pcm_into_file(path: Union[str, os.PathLike], waveform: np.ndarray,
                      sample_rate: int) -> None:
    """Rewrite the MP4 at ``path`` with a PCM track added — the
    read→mux→rewrite step shared by every in-image synthesizer
    (full_chain / bench_serving / demo_frontend test uploads)."""
    with open(path, "rb") as f:
        data = mux_pcm_track(f.read(), waveform, sample_rate)
    with open(path, "wb") as f:
        f.write(data)


def mux_pcm_track(mp4: bytes, waveform: np.ndarray,
                  sample_rate: int) -> bytes:
    """Return ``mp4`` with a 16-bit mono PCM audio track added.

    The original ``moov`` is blanked to a same-size ``free`` box (no
    payload byte moves, so existing chunk offsets stay valid) and a new
    ``mdat`` (PCM frames) + patched ``moov`` (original + extra trak,
    mvhd duration/next-track-id updated) are appended."""
    wav = np.asarray(waveform, np.float32).reshape(-1)
    pcm = np.clip(wav * 32768.0, -32768, 32767).astype("<i2").tobytes()
    n = len(pcm) // 2
    if n == 0:
        raise MuxError("empty waveform")

    f = io.BytesIO(mp4)
    boxes = list(_iter_boxes(f, 0, len(mp4)))
    moov = next(((hs, s, e) for t, hs, s, e in boxes if t == b"moov"), None)
    if moov is None:
        raise MuxError("input has no moov box (not a progressive MP4)")
    hs, s, e = moov
    if hs != 8:
        raise MuxError("64-bit moov box; not supported")
    moov_body = bytearray(mp4[s + 8:e])

    # mvhd: read movie timescale, patch duration + next_track_id.
    mf = io.BytesIO(bytes(moov_body))
    mvhd = _child(mf, 0, len(moov_body), b"mvhd")
    if mvhd is None:
        raise MuxError("moov has no mvhd")
    mhs, ms, me = mvhd
    version = moov_body[ms + mhs]
    body_off = ms + mhs + 4
    if version == 0:
        ts_off, dur_off, dur_fmt = body_off + 8, body_off + 12, ">I"
        next_off = body_off + 92
    elif version == 1:
        ts_off, dur_off, dur_fmt = body_off + 16, body_off + 20, ">Q"
        next_off = body_off + 104
    else:
        raise MuxError(f"mvhd version {version}")
    (movie_ts,) = struct.unpack(">I", moov_body[ts_off:ts_off + 4])
    dur_size = struct.calcsize(dur_fmt)
    (movie_dur,) = struct.unpack(
        dur_fmt, moov_body[dur_off:dur_off + dur_size])
    (track_id,) = struct.unpack(">I", moov_body[next_off:next_off + 4])
    audio_dur_movie = int(np.ceil(n / sample_rate * max(movie_ts, 1)))
    moov_body[dur_off:dur_off + dur_size] = struct.pack(
        dur_fmt, max(movie_dur, audio_dur_movie))
    moov_body[next_off:next_off + 4] = struct.pack(">I", track_id + 1)

    # Blank the original moov in place; append mdat(pcm) + patched moov.
    out = bytearray(mp4)
    out[s:s + 8] = struct.pack(">I", e - s) + b"free"
    out[s + 8:e] = b"\x00" * (e - s - 8)
    data_offset = len(out) + 8             # into the appended mdat payload
    if data_offset + len(pcm) >= 1 << 32:
        raise MuxError("output would need co64 offsets (>4 GiB)")
    trak = _pcm_trak(track_id, n, sample_rate, audio_dur_movie, data_offset)
    moov_body += trak
    new_moov = struct.pack(">I", 8 + len(moov_body)) + b"moov" + moov_body
    return bytes(out) + _box(b"mdat", pcm) + new_moov
