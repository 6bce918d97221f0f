"""Pure-Python FLV → MP4 remux (no transcode, no ffmpeg).

Copied from ``mmer_tpu/serve/remux.py``: the port imports nothing of the
JAX package, and ``tests/test_torch_media.py`` holds this copy to the
original on the original's test inputs.

Closes the reference's FLV-preview capability (reference
front-end/src/components/VideoPlayer.tsx:389-441 ships ffmpeg.wasm into the
browser to convert FLV uploads before playback; :478-544 adds an flv.js
streaming fallback).  Browsers cannot play FLV natively, but an FLV that
carries H.264 video + AAC audio — the overwhelmingly common pairing, and
what CREMA-D-era tooling emits — needs no transcoding at all: FLV stores
AVC payloads in the SAME length-prefixed AVCC layout MP4 uses, and raw AAC
frames map 1:1 onto MP4 samples.  So the backend remuxes by *copying
payload bytes* and rewriting container metadata, in pure Python, with no
codec work and no external binaries.

Exposed as ``POST /remux/`` (serve/app.py); the frontend calls it for FLV
uploads and previews the returned MP4 (frontend/src/lib/api.ts).  MP3
audio (FLV sound format 2/14) is ALSO copyable: MP4 carries MP3 with
object-type 0x6B in the esds, so H.264+MP3 FLVs remux without touching a
codec.  FLVs whose *video* is not AVC (Sorenson H.263, VP6) raise
:class:`RemuxError` here and fall through to the cv2 transcode fallback
(serve/transcode.py — the server-side analog of the reference's
ffmpeg.wasm libx264→mpeg4 fallback chain, VideoPlayer.tsx:336-360);
only when that also fails does the API answer 415 and the frontend show
the notice.

Format references (public specs): Adobe Video File Format Spec v10 (FLV
tags), ISO/IEC 14496-12 (MP4 boxes), 14496-15 (avcC), 14496-3 §1.6.2.1
(AudioSpecificConfig), ITU-T H.264 §7.3.2.1.1 (SPS, for display size).

Known timing simplifications (preview-quality, documented): audio samples
get constant ``frame_len``-sample deltas in the samplerate timescale
(exact for gapless CBR AAC — the normal case; an FLV with dropped audio
frames mid-stream accumulates drift), a nonzero initial DTS offset
between tracks is preserved with an empty-edit ``elst``, single-frame
video tracks assume 25 fps for their one delta, and duplicate video DTS
values get 1 ms floors.  Uploads are analyzed from the ORIGINAL file
server-side either way — the remux affects only the browser preview.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

__all__ = ["RemuxError", "flv_to_mp4", "parse_flv", "parse_sps",
           "parse_audio_specific_config", "parse_mp3_header"]


class RemuxError(ValueError):
    """Input is not an FLV we can losslessly remux (bad container or a
    codec other than H.264/AAC)."""


# --------------------------------------------------------------------------
# FLV demux
# --------------------------------------------------------------------------

@dataclass
class FlvStreams:
    """Demuxed elementary streams, payloads byte-identical to the FLV."""

    avcc: Optional[bytes] = None          # AVCDecoderConfigurationRecord
    asc: Optional[bytes] = None           # AudioSpecificConfig
    # (dts_ms, cts_offset_ms, keyframe, payload) — payload is AVCC NALUs
    video: List[Tuple[int, int, bool, bytes]] = field(default_factory=list)
    audio: List[Tuple[int, bytes]] = field(default_factory=list)  # (dts_ms, frame)
    audio_codec: Optional[str] = None     # "aac" | "mp3" (None until seen)
    # codec ids of tags dropped under skip_unsupported (diagnostics)
    skipped_video_codecs: List[int] = field(default_factory=list)
    skipped_audio_formats: List[int] = field(default_factory=list)


def _s24(b: bytes) -> int:
    v = int.from_bytes(b, "big")
    return v - (1 << 24) if v & 0x800000 else v


def parse_flv(data: bytes, skip_unsupported: bool = False) -> FlvStreams:
    """Walk FLV tags → H.264 video + AAC/MP3 audio elementary streams.

    Raises :class:`RemuxError` on a non-FLV header, or — unless
    ``skip_unsupported`` — on video/audio tags whose codec cannot be
    copied into MP4 (AVC video; AAC or MP3 audio).  With
    ``skip_unsupported`` those tags are dropped and their codec ids
    recorded, so the transcode fallback can still salvage a copyable
    audio track alongside a cv2-transcoded video track.
    """
    if len(data) < 13 or data[:3] != b"FLV":
        raise RemuxError("not an FLV file")
    header_size = struct.unpack(">I", data[5:9])[0]
    if header_size < 9:
        raise RemuxError("corrupt FLV header")

    out = FlvStreams()
    off = header_size + 4                 # skip first PreviousTagSize
    n = len(data)
    while off + 11 <= n:
        tag_type = data[off]
        size = int.from_bytes(data[off + 1:off + 4], "big")
        ts = (int.from_bytes(data[off + 4:off + 7], "big")
              | (data[off + 7] << 24))
        body = data[off + 11:off + 11 + size]
        off += 11 + size + 4              # tag + trailing PreviousTagSize
        if len(body) < size:              # truncated final tag: stop cleanly
            break

        if tag_type == 9 and len(body) >= 1:          # video
            frame_type, codec = body[0] >> 4, body[0] & 0x0F
            if codec != 7:
                if skip_unsupported:
                    if codec not in out.skipped_video_codecs:
                        out.skipped_video_codecs.append(codec)
                    continue
                raise RemuxError(
                    f"FLV video codec id {codec} is not AVC/H.264; "
                    "remux-by-copy impossible (transcode required)")
            if len(body) < 5:
                continue
            pkt, cts = body[1], _s24(body[2:5])
            payload = bytes(body[5:])
            if pkt == 0 and payload:
                out.avcc = payload
            elif pkt == 1 and payload:
                out.video.append((ts, cts, frame_type == 1, payload))
        elif tag_type == 8 and len(body) >= 1:        # audio
            fmt = body[0] >> 4
            if fmt in (10, 2, 14):
                codec = "aac" if fmt == 10 else "mp3"
                if out.audio_codec is not None and out.audio_codec != codec:
                    # A spliced/corrupt FLV that changes audio codec
                    # mid-stream cannot become a single-codec MP4 audio
                    # track by byte copy.  Strict mode fails loudly so
                    # the caller routes to the transcode fallback; the
                    # fallback's own lenient parse keeps the FIRST codec
                    # and drops the conflicting tags (garbled audio is
                    # worse than missing tail audio).
                    if skip_unsupported:
                        if fmt not in out.skipped_audio_formats:
                            out.skipped_audio_formats.append(fmt)
                        continue
                    raise RemuxError(
                        "FLV changes audio codec mid-stream "
                        f"({out.audio_codec} -> {codec}); copy remux "
                        "impossible")
            if fmt == 10:                             # AAC (packetized)
                if len(body) < 2:
                    continue
                out.audio_codec = "aac"
                pkt, payload = body[1], bytes(body[2:])
                if pkt == 0 and payload:
                    out.asc = payload
                elif pkt == 1 and payload:
                    out.audio.append((ts, payload))
            elif fmt in (2, 14):                      # MP3 / MP3-8kHz
                # MP3 tags have no packet-type byte: the MP3 frame starts
                # right after the sound header (Adobe FLV spec, AUDIODATA).
                # MP4 carries MP3 via esds object-type 0x6B — still a
                # byte copy, no codec work.
                out.audio_codec = "mp3"
                payload = bytes(body[1:])
                if payload:
                    out.audio.append((ts, payload))
            else:
                if skip_unsupported:
                    if fmt not in out.skipped_audio_formats:
                        out.skipped_audio_formats.append(fmt)
                    continue
                raise RemuxError(
                    f"FLV audio format id {fmt} is not AAC or MP3; "
                    "remux-by-copy impossible (transcode required)")
        # tag_type 18 (onMetaData script) is ignored: display size comes
        # from the SPS, which is authoritative where metadata often lies.
    return out


# --------------------------------------------------------------------------
# H.264 SPS → display width/height   (ITU-T H.264 §7.3.2.1.1)
# --------------------------------------------------------------------------

class _BitReader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def u(self, bits: int) -> int:
        v = 0
        for _ in range(bits):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def ue(self) -> int:                  # exp-golomb unsigned
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 31:
                raise RemuxError("corrupt SPS (runaway exp-golomb)")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self) -> int:                  # exp-golomb signed
        k = self.ue()
        return (k + 1) // 2 if k % 2 else -(k // 2)


def _strip_emulation(nalu: bytes) -> bytes:
    """Remove 0x000003 emulation-prevention bytes from RBSP."""
    out = bytearray()
    zeros = 0
    for b in nalu:
        if zeros >= 2 and b == 3:
            zeros = 0
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def parse_sps(sps: bytes) -> Tuple[int, int]:
    """(width, height) in display pixels from an SPS NALU (incl. header)."""
    r = _BitReader(_strip_emulation(sps[1:]))     # skip NAL header byte
    profile = r.u(8)
    r.u(8)                                        # constraint flags + level…
    r.u(8)
    r.ue()                                        # sps_id
    chroma = 1
    if profile in (100, 110, 122, 244, 44, 83, 86,
                   118, 128, 138, 139, 134, 135):
        chroma = r.ue()
        if chroma == 3:
            r.u(1)                                # separate_colour_plane
        r.ue(); r.ue(); r.u(1)                    # bit depths + qpprime
        if r.u(1):                                # seq_scaling_matrix
            for i in range(8 if chroma != 3 else 12):
                if r.u(1):                        # scaling list present
                    size = 16 if i < 6 else 64
                    last, nxt = 8, 8
                    for _ in range(size):
                        if nxt:
                            nxt = (last + r.se() + 256) % 256
                        last = nxt if nxt else last
    r.ue()                                        # log2_max_frame_num
    poc_type = r.ue()
    if poc_type == 0:
        r.ue()
    elif poc_type == 1:
        r.u(1); r.se(); r.se()
        for _ in range(r.ue()):
            r.se()
    r.ue(); r.u(1)                                # ref frames, gaps
    pw = r.ue() + 1
    ph = r.ue() + 1
    frame_mbs_only = r.u(1)
    if not frame_mbs_only:
        r.u(1)                                    # mb_adaptive
    r.u(1)                                        # direct_8x8
    crop_l = crop_r = crop_t = crop_b = 0
    if r.u(1):                                    # frame_cropping
        crop_l, crop_r, crop_t, crop_b = r.ue(), r.ue(), r.ue(), r.ue()
    sub_wc, sub_hc = {0: (1, 1), 1: (2, 2), 2: (2, 1), 3: (1, 1)}[chroma]
    unit_x = sub_wc if chroma else 1
    unit_y = sub_hc * (2 - frame_mbs_only) if chroma \
        else (2 - frame_mbs_only)
    width = pw * 16 - unit_x * (crop_l + crop_r)
    height = (2 - frame_mbs_only) * ph * 16 - unit_y * (crop_t + crop_b)
    return width, height


def _sps_from_avcc(avcc: bytes) -> Optional[bytes]:
    """First SPS NALU out of an AVCDecoderConfigurationRecord."""
    if len(avcc) < 8:
        return None
    num_sps = avcc[5] & 0x1F
    off = 6
    if num_sps < 1 or off + 2 > len(avcc):
        return None
    ln = struct.unpack(">H", avcc[off:off + 2])[0]
    sps = avcc[off + 2:off + 2 + ln]
    return sps if len(sps) == ln else None


# --------------------------------------------------------------------------
# AAC AudioSpecificConfig  (ISO 14496-3 §1.6.2.1)
# --------------------------------------------------------------------------

_AAC_RATES = (96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
              16000, 12000, 11025, 8000, 7350)


def parse_audio_specific_config(asc: bytes) -> Tuple[int, int, int]:
    """(sample_rate, channels, samples_per_frame) from an ASC blob."""
    r = _BitReader(asc)
    obj = r.u(5)
    if obj == 31:
        obj = 32 + r.u(6)
    freq_idx = r.u(4)
    rate = r.u(24) if freq_idx == 15 else (
        _AAC_RATES[freq_idx] if freq_idx < len(_AAC_RATES) else 44100)
    channels = r.u(4)
    frame_len = 1024
    try:                                   # GASpecificConfig frameLengthFlag
        if r.u(1):
            frame_len = 960
    except IndexError:
        pass
    return rate, max(channels, 1), frame_len


# --------------------------------------------------------------------------
# MP3 frame header  (ISO 11172-3 §2.4.1.3 / 13818-3)
# --------------------------------------------------------------------------

_MP3_RATES_V1 = (44100, 48000, 32000)


def parse_mp3_header(frame: bytes) -> Tuple[int, int, int]:
    """(sample_rate, channels, samples_per_frame) from an MPEG audio frame
    header — enough to build the MP4 sample timing for a copied MP3 track.

    Raises :class:`RemuxError` when the 11-bit sync word is absent or the
    layer/rate fields are reserved values.
    """
    if len(frame) < 4 or frame[0] != 0xFF or (frame[1] & 0xE0) != 0xE0:
        raise RemuxError("MP3 frame lacks a sync word")
    version_bits = (frame[1] >> 3) & 0x3   # 0=2.5, 2=MPEG-2, 3=MPEG-1
    layer_bits = (frame[1] >> 1) & 0x3     # 1=III, 2=II, 3=I
    if version_bits == 1 or layer_bits == 0:
        raise RemuxError("reserved MPEG audio version/layer")
    rate_idx = (frame[2] >> 2) & 0x3
    if rate_idx == 3:
        raise RemuxError("reserved MPEG audio sample-rate index")
    rate = _MP3_RATES_V1[rate_idx]
    if version_bits == 2:                  # MPEG-2: half rates
        rate //= 2
    elif version_bits == 0:                # MPEG-2.5: quarter rates
        rate //= 4
    channels = 1 if ((frame[3] >> 6) & 0x3) == 3 else 2
    if layer_bits == 3:                    # Layer I
        spf = 384
    elif layer_bits == 2:                  # Layer II
        spf = 1152
    else:                                  # Layer III
        spf = 1152 if version_bits == 3 else 576
    return rate, channels, spf


# --------------------------------------------------------------------------
# MP4 mux
# --------------------------------------------------------------------------

def _box(typ: bytes, *payload: bytes) -> bytes:
    body = b"".join(payload)
    return struct.pack(">I", 8 + len(body)) + typ + body


def _full(typ: bytes, version: int, flags: int, *payload: bytes) -> bytes:
    return _box(typ, bytes([version]) + flags.to_bytes(3, "big"),
                *payload)


def _matrix() -> bytes:
    return struct.pack(">9I", 0x00010000, 0, 0, 0, 0x00010000, 0, 0, 0,
                       0x40000000)


def _stts(deltas: List[int]) -> bytes:
    runs: List[Tuple[int, int]] = []
    for d in deltas:
        if runs and runs[-1][1] == d:
            runs[-1] = (runs[-1][0] + 1, d)
        else:
            runs.append((1, d))
    body = struct.pack(">I", len(runs)) + b"".join(
        struct.pack(">II", c, d) for c, d in runs)
    return _full(b"stts", 0, 0, body)


def _ctts(offsets: List[int]) -> bytes:
    runs: List[Tuple[int, int]] = []
    for o in offsets:
        if runs and runs[-1][1] == o:
            runs[-1] = (runs[-1][0] + 1, o)
        else:
            runs.append((1, o))
    body = struct.pack(">I", len(runs)) + b"".join(
        struct.pack(">Ii", c, o) for c, o in runs)
    return _full(b"ctts", 1, 0, body)      # version 1: signed offsets


def _stbl_common(sizes: List[int], offsets: List[int]) -> bytes:
    stsc = _full(b"stsc", 0, 0,
                 struct.pack(">IIII", 1, 1, 1, 1))     # 1 sample per chunk
    stsz = _full(b"stsz", 0, 0, struct.pack(">II", 0, len(sizes)),
                 b"".join(struct.pack(">I", s) for s in sizes))
    stco = _full(b"stco", 0, 0, struct.pack(">I", len(offsets)),
                 b"".join(struct.pack(">I", o) for o in offsets))
    return stsc + stsz + stco


def _avc1_entry(avcc: bytes, width: int, height: int) -> bytes:
    entry = (b"\x00" * 6 + struct.pack(">H", 1)        # data_ref_index
             + b"\x00" * 16
             + struct.pack(">HH", width, height)
             + struct.pack(">II", 0x00480000, 0x00480000)
             + b"\x00" * 4
             + struct.pack(">H", 1)                    # frame_count
             + b"\x00" * 32                            # compressorname
             + struct.pack(">Hh", 0x0018, -1))
    return _box(b"avc1", entry, _box(b"avcC", avcc))


def _esds(asc: Optional[bytes], avg_bitrate: int,
          object_type: int = 0x40) -> bytes:
    """ES descriptor.  ``object_type`` 0x40 = AAC (DecoderSpecificInfo =
    the ASC blob), 0x6B = MPEG-1 audio layer III (MP3 — no DSI exists)."""
    def desc(tag: int, body: bytes) -> bytes:
        # Expandable length, 4-byte canonical form (handles any size).
        ln = len(body)
        enc = bytes([0x80 | ((ln >> 21) & 0x7F), 0x80 | ((ln >> 14) & 0x7F),
                     0x80 | ((ln >> 7) & 0x7F), ln & 0x7F])
        return bytes([tag]) + enc + body

    dsi = desc(0x05, asc) if asc is not None else b""
    dcd = desc(0x04, struct.pack(">BBBHII", object_type, 0x15, 0, 0,
                                 max(avg_bitrate, 1) * 2,
                                 max(avg_bitrate, 1)) + dsi)
    sl = desc(0x06, b"\x02")
    es = desc(0x03, struct.pack(">HB", 0, 0) + dcd + sl)
    return _full(b"esds", 0, 0, es)


def _mp4a_entry(asc: Optional[bytes], rate: int, channels: int,
                avg_bitrate: int, object_type: int = 0x40) -> bytes:
    entry = (b"\x00" * 6 + struct.pack(">H", 1)
             + b"\x00" * 8
             + struct.pack(">HH", channels, 16)
             + b"\x00" * 4
             # 16.16 fixed field can't hold rates >= 65536 Hz (88.2k/96k
             # AAC): write 0 so players fall back to the esds ASC instead
             # of a truncated wrong rate.
             + struct.pack(">I", 0 if rate >= 1 << 16 else rate << 16))
    return _box(b"mp4a", entry, _esds(asc, avg_bitrate, object_type))


def _elst(offset_movie: int, media_dur_movie: int) -> bytes:
    """Edit list: an empty edit of ``offset_movie`` (movie-timescale) ticks
    delaying the track start, then the whole media — preserves a nonzero
    initial DTS offset between FLV tracks (e.g. audio beginning 300 ms
    after video) instead of silently snapping both tracks to t=0.

    Owns the no-offset rule: returns ``b""`` (write no edts at all) when
    the offset is zero."""
    if offset_movie <= 0:
        return b""
    entries = [(offset_movie, -1), (media_dur_movie, 0)]
    body = struct.pack(">I", len(entries)) + b"".join(
        struct.pack(">IiHH", seg_dur, media_time, 1, 0)
        for seg_dur, media_time in entries)
    return _box(b"edts", _full(b"elst", 0, 0, body))


def _trak(track_id: int, timescale: int, duration: int, mvhd_dur: int,
          handler: bytes, name: bytes, media_header: bytes, stsd_entry: bytes,
          deltas: List[int], sizes: List[int], offsets: List[int],
          width: int = 0, height: int = 0,
          keyframes: Optional[List[int]] = None,
          ctts_offsets: Optional[List[int]] = None,
          edts: bytes = b"") -> bytes:
    tkhd = _full(b"tkhd", 0, 3,
                 struct.pack(">IIII", 0, 0, track_id, 0),
                 struct.pack(">I", mvhd_dur),
                 b"\x00" * 8,
                 struct.pack(">hhhh", 0, 0,
                             0x0100 if handler == b"soun" else 0, 0),
                 _matrix(),
                 struct.pack(">II", width << 16, height << 16))
    mdhd = _full(b"mdhd", 0, 0,
                 struct.pack(">IIIIHH", 0, 0, timescale, duration,
                             0x55C4, 0))
    hdlr = _full(b"hdlr", 0, 0, b"\x00" * 4, handler, b"\x00" * 12,
                 name + b"\x00")
    dinf = _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1),
                               _full(b"url ", 0, 1)))
    stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1), stsd_entry)
    stbl = stsd + _stts(deltas)
    if ctts_offsets is not None and any(ctts_offsets):
        stbl += _ctts(ctts_offsets)
    # Omitting stss declares EVERY sample a sync sample (ISO 14496-12),
    # which is only correct when all frames really are keyframes — an
    # EMPTY keyframe list must still write an (empty) stss, else players
    # would seek to arbitrary P-frames.
    if keyframes is not None and len(keyframes) < len(sizes):
        stbl += _full(b"stss", 0, 0, struct.pack(">I", len(keyframes)),
                      b"".join(struct.pack(">I", k) for k in keyframes))
    stbl += _stbl_common(sizes, offsets)
    minf = _box(b"minf", media_header, dinf, _box(b"stbl", stbl))
    mdia = _box(b"mdia", mdhd, hdlr, minf)
    if edts:
        return _box(b"trak", tkhd, edts, mdia)
    return _box(b"trak", tkhd, mdia)


def _audio_codec_info(streams: FlvStreams) -> Tuple[int, int, int,
                                                    Optional[bytes], int]:
    """(rate, channels, samples_per_frame, decoder_specific_info,
    esds_object_type) for the FLV's audio track, either codec."""
    if streams.audio_codec == "mp3":
        rate, channels, frame_len = parse_mp3_header(streams.audio[0][1])
        return rate, channels, frame_len, None, 0x6B
    if streams.asc is None:
        raise RemuxError("FLV has AAC frames but no AudioSpecificConfig")
    try:
        rate, channels, frame_len = parse_audio_specific_config(streams.asc)
    except IndexError as e:              # truncated/garbage ASC blob
        raise RemuxError(f"unparseable AAC AudioSpecificConfig: {e}")
    return rate, channels, frame_len, streams.asc, 0x40


def _build_audio_trak(streams: FlvStreams, track_id: int,
                      audio_offsets: List[int], offset_ms: int,
                      movie_ts: int = 1000) -> Tuple[bytes, int]:
    """Audio trak box for a copied AAC/MP3 track, plus its total movie-
    timescale duration (initial offset + media).  Shared by the FLV copy
    remux and the transcode fallback's audio-salvage merge
    (serve/transcode.py)."""
    rate, channels, frame_len, dsi, oti = _audio_codec_info(streams)
    # Frames are a fixed frame_len samples; a constant delta in a
    # samplerate timescale avoids FLV's ms-rounding jitter.
    deltas = [frame_len] * len(streams.audio)
    duration = frame_len * len(streams.audio)
    media_ms = int(duration * 1000 / rate)
    total_bytes = sum(len(s[1]) for s in streams.audio)
    avg_bitrate = min(int(total_bytes * 8 * rate / max(duration, 1)),
                      2 ** 30)
    trak = _trak(
        track_id, rate, duration, offset_ms + media_ms,
        b"soun", b"mmer_tpu audio remux", _full(b"smhd", 0, 0, b"\x00" * 4),
        _mp4a_entry(dsi, rate, channels, avg_bitrate, oti),
        deltas, [len(s[1]) for s in streams.audio], audio_offsets,
        edts=_elst(offset_ms, media_ms))
    return trak, offset_ms + media_ms


def flv_to_mp4(flv: bytes) -> bytes:
    """Remux an H.264 + AAC/MP3 FLV into a progressive MP4, payloads
    copied verbatim.  Raises :class:`RemuxError` for anything else."""
    streams = parse_flv(flv)
    if not streams.video and not streams.audio:
        raise RemuxError("FLV contains no media samples")
    if streams.video and streams.avcc is None:
        raise RemuxError("FLV has AVC frames but no sequence header")
    if streams.audio:
        _audio_codec_info(streams)        # validate before any allocation

    movie_ts = 1000                       # FLV timestamps are milliseconds

    # ---- interleave samples into mdat in DTS order ---------------------
    order: List[Tuple[int, int, int]] = []          # (dts, track, index)
    for i, (dts, _, _, _) in enumerate(streams.video):
        order.append((dts, 0, i))
    for i, (dts, _) in enumerate(streams.audio):
        order.append((dts, 1, i))
    order.sort(key=lambda t: (t[0], t[1]))

    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 0x200),
                b"isomiso2avc1mp41")
    base = len(ftyp) + 8                  # absolute offset of mdat payload
    # stco chunk offsets and box sizes are packed as 32-bit '>I'; past
    # 4 GiB that struct.error would surface as an opaque HTTP 500.  Fail
    # cleanly BEFORE allocating the interleaved copy (supporting larger
    # media would need co64 + 64-bit box sizes).
    total = base + sum(len(s[3]) for s in streams.video) \
        + sum(len(s[1]) for s in streams.audio)
    if total >= 1 << 32:
        raise RemuxError(
            f"remuxed media is {total} bytes; offsets beyond 4 GiB need "
            f"co64 boxes, which this copy-remux does not emit")
    mdat_payload = bytearray()
    video_offsets = [0] * len(streams.video)
    audio_offsets = [0] * len(streams.audio)
    for _, track, i in order:
        data = streams.video[i][3] if track == 0 else streams.audio[i][1]
        if track == 0:
            video_offsets[i] = base + len(mdat_payload)
        else:
            audio_offsets[i] = base + len(mdat_payload)
        mdat_payload += data
    mdat = _box(b"mdat", bytes(mdat_payload))

    traks = []
    durations_ms = [0]

    # Preserve nonzero initial DTS offsets between tracks (e.g. audio
    # starting 300 ms after video) with empty-edit lists; within each
    # track, timing is rebased to its own first sample.
    firsts = []
    if streams.video:
        firsts.append(streams.video[0][0])
    if streams.audio:
        firsts.append(streams.audio[0][0])
    t0 = min(firsts)

    if streams.video:
        dts_list = [s[0] for s in streams.video]
        deltas = [max(b - a, 1) for a, b in zip(dts_list, dts_list[1:])]
        deltas.append(deltas[-1] if deltas else 40)
        duration = sum(deltas)
        offset_ms = dts_list[0] - t0
        durations_ms.append(offset_ms + duration)
        sps = _sps_from_avcc(streams.avcc)
        try:
            width, height = parse_sps(sps) if sps else (0, 0)
        except (RemuxError, IndexError):
            width, height = 0, 0
        keyframes = [i + 1 for i, s in enumerate(streams.video) if s[2]]
        traks.append(_trak(
            1, movie_ts, duration, durations_ms[-1], b"vide",
            b"mmer_tpu video remux", _full(b"vmhd", 0, 1, b"\x00" * 8),
            _avc1_entry(streams.avcc, width, height),
            deltas, [len(s[3]) for s in streams.video], video_offsets,
            width=width, height=height, keyframes=keyframes,
            ctts_offsets=[s[1] for s in streams.video],
            edts=_elst(offset_ms, duration)))

    if streams.audio:
        trak, dur_ms = _build_audio_trak(
            streams, 2 if streams.video else 1, audio_offsets,
            streams.audio[0][0] - t0, movie_ts)
        traks.append(trak)
        durations_ms.append(dur_ms)

    mvhd = _full(b"mvhd", 0, 0,
                 struct.pack(">IIII", 0, 0, movie_ts, max(durations_ms)),
                 struct.pack(">IHH", 0x00010000, 0x0100, 0),
                 b"\x00" * 8, _matrix(), b"\x00" * 24,
                 struct.pack(">I", len(traks) + 1))
    moov = _box(b"moov", mvhd, *traks)
    return ftyp + mdat + moov
