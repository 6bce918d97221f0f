"""Dataset catalog: filename → label maps and key-based audio/video pairing.

Label semantics match the reference exactly (train2.py:328-349):

- RAVDESS names contain "-"; emotion code is field 3 of the 7-field name,
  calm(02)/surprise(08) are dropped, and {01,03,04,05,06,07} map to the final
  6-class ids {NEU,HAP,SAD,ANG,FEA,DIS} = {0..5}.
- CREMA-D names are ``ACTOR_SENTENCE_EMOTION_LEVEL``; token 3 maps through
  {ANG,DIS,FEA,HAP,NEU,SAD} to the same final ids.

Pairing: the reference pairs the two sorted file lists positionally
(train2.py:325), which silently misaligns 2,694/8,880 pairs because the audio
dir has one extra file (SURVEY.md §2.3).  This module pairs by canonical
sample key instead; positional mode is kept only for reproducing the
reference's behavior in comparisons.
"""

from __future__ import annotations

import glob
import os
import re
from dataclasses import dataclass
from typing import List, Optional

# RAVDESS emotion code (field 3) → final label id (train2.py:338)
RAVDESS_MAP = {1: 0, 3: 1, 4: 2, 5: 3, 6: 4, 7: 5}
RAVDESS_DROPPED = (2, 8)  # calm, surprise (train2.py:334)

# CREMA-D emotion token → final label id.  The reference routes through an
# intermediate code map (train2.py:343-349); composed, it is:
CREMAD_MAP = {"NEU": 0, "HAP": 1, "SAD": 2, "ANG": 3, "FEA": 4, "DIS": 5}

_RAVDESS_CODE_RE = re.compile(r"(\d{2}(?:-\d{2}){6})")


def label_from_name(basename: str) -> Optional[int]:
    """Map a feature-file basename to its final label id, or None if the
    sample belongs to a dropped class.

    Mirrors reference train2.py:328-349 (labels always come from the name).
    """
    if "-" in basename:
        m = _RAVDESS_CODE_RE.search(basename)
        if not m:
            raise ValueError(f"unrecognized RAVDESS name: {basename}")
        code = int(m.group(1).split("-")[2])
        if code in RAVDESS_DROPPED:
            return None
        return RAVDESS_MAP[code]
    emotion = basename.split("_")[2]
    return CREMAD_MAP[emotion]


def sample_key(basename: str) -> str:
    """Canonical per-clip key shared by the video and audio artifacts.

    Video names end in ``*_faces_mp4_features.npy`` (video_extractor.py:174),
    audio names in ``*_voice_mp4_features.npy`` (voice_extractor.py:89,94).
    Stripping those suffixes yields the same clip key for both modalities,
    e.g. ``1001_DFA_ANG_XX`` or ``Video_Speech_Actor_01_01-01-01-01-01-01-01``.
    """
    stem = os.path.basename(basename)
    if stem.endswith(".npy"):
        stem = stem[: -len(".npy")]
    for suffix in ("_faces_mp4_features", "_voice_mp4_features", "_features"):
        if stem.endswith(suffix):
            stem = stem[: -len(suffix)]
            break
    return stem


@dataclass(frozen=True)
class CatalogEntry:
    key: str
    video_path: str
    audio_path: str
    label: int


def build_catalog(video_feat_dir: str, audio_feat_dir: str,
                  pairing: str = "key") -> List[CatalogEntry]:
    """Pair video/audio feature files and attach labels.

    ``pairing='key'`` (default): join on :func:`sample_key`; unmatched files
    on either side are dropped (and counted).  ``pairing='positional'``:
    reproduce the reference's ``zip(sorted, sorted)`` (train2.py:325) for
    behavioral comparisons — labels still come from the *video* name.
    """
    video_files = sorted(glob.glob(os.path.join(video_feat_dir, "*.npy")))
    audio_files = sorted(glob.glob(os.path.join(audio_feat_dir, "*.npy")))
    if not video_files or not audio_files:
        raise FileNotFoundError(
            f"no feature files under {video_feat_dir} / {audio_feat_dir}")

    entries: List[CatalogEntry] = []
    if pairing == "positional":
        for v, a in zip(video_files, audio_files):
            label = label_from_name(os.path.basename(v))
            if label is None:
                continue
            entries.append(CatalogEntry(sample_key(v), v, a, label))
        return entries

    if pairing != "key":
        raise ValueError(f"unknown pairing mode: {pairing}")

    audio_by_key = {sample_key(a): a for a in audio_files}
    for v in video_files:
        key = sample_key(v)
        a = audio_by_key.get(key)
        if a is None:
            continue
        label = label_from_name(os.path.basename(v))
        if label is None:
            continue
        entries.append(CatalogEntry(key, v, a, label))
    return entries
