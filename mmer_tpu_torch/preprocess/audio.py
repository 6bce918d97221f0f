"""Host audio decode → 16 kHz mono waveforms + artifact naming, copied from
the host side of ``mmer_tpu/preprocess/audio.py`` (the port imports nothing
from the JAX package; a test holds this copy to the original).  The video
container routes (``extract_audio_track`` and the converters built on it)
come with the serving slice.

Decoder availability is gated: WAV decodes natively via the stdlib; other
formats (mp3/aac/ogg/flac) go through the ``ffmpeg`` binary when present.
:func:`load_waveform` returns None when no decoder can handle the file, and
callers skip-and-continue — the same per-file failure posture as the
reference (voice_extractor.py:124-125).

Defect fixed (not replicated): the reference feeds native-sample-rate audio
straight into the 16 kHz Wav2Vec2 front-end (voice_extractor.py:66 loads at
source rate, :39-44 then *declares* it 16 kHz).  RAVDESS ships 48 kHz audio,
so its embeddings came from 3× sped-up speech.  Here everything is properly
resampled with a polyphase filter before embedding.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import wave as wave_mod
from typing import Iterator, Optional

import numpy as np

AUDIO_EXTENSIONS = {".mp3", ".wav", ".flac", ".aac", ".ogg"}


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def _read_wav(path: str) -> Optional[tuple]:
    """stdlib WAV reader → (float32 mono waveform, sample_rate)."""
    try:
        with wave_mod.open(path, "rb") as f:
            sr = f.getframerate()
            n = f.getnframes()
            ch = f.getnchannels()
            width = f.getsampwidth()
            raw = f.readframes(n)
    except (wave_mod.Error, EOFError, OSError):
        return None
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        return None
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    return data, sr


def _decode_via_ffmpeg(path: str, sample_rate: int) -> Optional[np.ndarray]:
    """Any container → mono float32 at ``sample_rate`` via the ffmpeg CLI."""
    if not ffmpeg_available():
        return None
    cmd = ["ffmpeg", "-v", "error", "-i", path, "-vn", "-ac", "1",
           "-ar", str(sample_rate), "-f", "f32le", "-"]
    try:
        out = subprocess.run(cmd, capture_output=True, check=True).stdout
    except (subprocess.CalledProcessError, OSError):
        return None
    if not out:
        return None
    return np.frombuffer(out, np.float32).copy()


def resample(waveform: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Polyphase resampling (scipy), identity when rates match."""
    if src_rate == dst_rate:
        return waveform
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(src_rate, dst_rate)
    return resample_poly(waveform, dst_rate // g, src_rate // g
                         ).astype(np.float32)


def load_waveform(path: str, sample_rate: int = 16000) -> Optional[np.ndarray]:
    """Decode any supported audio file → mono float32 at ``sample_rate``."""
    if path.lower().endswith(".wav"):
        decoded = _read_wav(path)
        if decoded is not None:
            data, sr = decoded
            return resample(data, sr, sample_rate)
    return _decode_via_ffmpeg(path, sample_rate)


def iter_audio_files(folder: str) -> Iterator[str]:
    for root, _, files in os.walk(folder):
        for name in sorted(files):
            if os.path.splitext(name)[1].lower() in AUDIO_EXTENSIONS:
                yield os.path.join(root, name)


def audio_output_name(basename: str) -> str:
    """The reference's audio artifact naming (voice_extractor.py:84-94):
    RAVDESS stems (dash-separated) become
    ``Video_Speech_Actor_{actor}_{stem}_voice_mp4_features.npy``;
    CREMA-D stems keep ``{stem}_voice_mp4_features.npy``."""
    stem = os.path.splitext(basename)[0]
    if "-" in stem:
        actor = stem.split("-")[-1]
        return f"Video_Speech_Actor_{actor}_{stem}_voice_mp4_features.npy"
    return f"{stem}_voice_mp4_features.npy"
